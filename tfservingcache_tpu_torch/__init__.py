"""tfservingcache_tpu_torch — the PyTorch/CUDA port of tfservingcache_tpu.

A multi-tenant model-serving cache speaking the TF Serving REST protocol:
artifacts are fetched from a store into a byte-budgeted disk LRU, loaded
into GPU memory under an LRU of resident models, and run in-process with
PyTorch and hand-written CUDA kernels (``ops/csrc``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
