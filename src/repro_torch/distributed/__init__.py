"""Sharding recipes for the (arch x shape) cells' dry run."""
