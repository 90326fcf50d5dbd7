"""Model substrate of the serving path: config, layers, dense transformer."""
