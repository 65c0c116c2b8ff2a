"""PyTorch + CUDA port of the NetFuse multi-model serving system.

Mirrors the module paths of the JAX package ``repro`` (configs, models,
kernels, serving, launch) so each module's counterpart is found under the
same name.  Imports ``torch`` only; the hand-written Hopper kernels under
``csrc/`` are compiled at their first use on a CUDA tensor.
"""
