"""The architecture pool: ``configs.registry.get_arch(id)``."""
