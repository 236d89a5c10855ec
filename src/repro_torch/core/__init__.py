"""Graph-sequence data model, canonical forms and the host miners."""
