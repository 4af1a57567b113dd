"""sslrec_tpu_torch: the PyTorch/CUDA port of ``sslrec_tpu``.

The JAX package stays the reference; this package imports nothing from it.
Modules mirror ``sslrec_tpu``'s names.  Entry point:
``python -m sslrec_tpu_torch.main --model lightgcn [--device cuda|cpu]``.
"""
