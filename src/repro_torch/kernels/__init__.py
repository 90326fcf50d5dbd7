"""Hand-written CUDA kernels for Hopper and their build.

* ``fragscore``        -- the fragmentation-scoring kernels (paper
  Algorithms 1/2): ``fragscore``, ``mfi_delta``, ``delta_from_base``,
  ``select_from_base``, ``migrate_refine``
* ``decode_attention`` -- GQA decode attention over a KV cache (serving)

Each kernel's wrapper takes its plain torch version (``ref.py``) for CPU
tensors and launches the kernel, or raises, for CUDA tensors; ``ops.py``
holds the public wrappers.
"""
