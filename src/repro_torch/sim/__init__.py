"""The batched Monte-Carlo engine and its load model."""
