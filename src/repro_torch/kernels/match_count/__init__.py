"""match_count: the embedding-join extension-signature kernel."""
