"""GQA flash-decode attention: the hand-written CUDA kernel, its wrapper and plain version."""
