"""PyTorch/CUDA port of ``video_spike_tpu`` for one NVIDIA H100.

Same subpackage layout and module names as the JAX package (``core``,
``data``, ``ops``, ``models``, ``train``, ``cli``) so each module's
counterpart is easy to find. The port imports torch, never JAX, and
nothing of the JAX package. Entry points run on ``cuda`` unless the caller
asks for the CPU.
"""
