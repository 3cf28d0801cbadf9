from . import loaders, seeded  # noqa: F401
