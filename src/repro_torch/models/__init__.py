"""Dense all-global decoder: layers, paged attention, KV pools, weights."""
