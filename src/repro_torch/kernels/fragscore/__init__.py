"""Fragmentation-scoring kernels: ``fragscore``, ``delta_from_base``, ``select_from_base``."""
