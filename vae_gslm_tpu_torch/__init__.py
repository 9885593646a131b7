"""PyTorch/CUDA port of ``vae_gslm_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``nn/transformer.py`` <-> ``vae_gslm_tpu/nn/transformer.py``) and
imports neither JAX nor anything of ``vae_gslm_tpu``.  Its entry
points run on the GPU unless the caller passes ``device="cpu"``.
Every Pallas kernel on a ported path is a hand-written Hopper kernel
under ``csrc/`` with a plain PyTorch version beside its wrapper.
"""
