"""Host-side pieces of the select wrapper that run for CPU tensors too."""

from repro_torch.kernels.fragscore import fragscore as tk


def test_pack_keys_is_computed_once_per_key_tuple():
    """The key code is cached per effective-key tuple: a second call with
    an equal tuple is a cache hit and gives the same code."""
    keys = (("frag-delta", 1.0), ("gpu", 1.0), ("anchor", -1.0))
    first = tk.pack_keys(keys)
    hits = tk.pack_keys.cache_info().hits
    assert tk.pack_keys(tuple(keys)) == first == (0 | (2 << 3) | ((3 | 4) << 6))
    assert tk.pack_keys.cache_info().hits == hits + 1
