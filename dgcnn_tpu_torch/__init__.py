"""PyTorch/CUDA port of dgcnn_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (``ops``, ``models``, ``train``, ``data``,
``utils``, ``cli``) and its channels-last ``(B, N, C)`` activations.  The
Pallas TPU kernels of the JAX package become hand-written CUDA kernels
(``csrc/``), each beside a plain PyTorch version of the same function; the
plain version serves CPU tensors, the kernel serves CUDA tensors.

Imports only torch, numpy and the standard library: no jax, no dgcnn_tpu.
"""
