"""bridged_gnn_tpu_torch — the PyTorch / CUDA port of bridged_gnn_tpu.

The first slice ports KT-GNN serving: graph build, padded and
degree-tiered slot layouts, the KT-GNN forward with its three heads, the
predictor and its HTTP front end. The attention forward of every KT-GNN
conv runs as a hand-written CUDA kernel for Hopper
(``csrc/attention_fwd.cu``, bound in ``ops/fused_kernels.py``); on CPU
tensors the same wrappers run their plain PyTorch versions.

Module names follow ``bridged_gnn_tpu`` so each port module sits at the
same path as its JAX counterpart. Importing the package sets no global
state and builds nothing.
"""

__version__ = "0.1.0"
