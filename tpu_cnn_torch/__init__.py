"""tpu_cnn_torch — the PyTorch/CUDA port of ``tpu_cnn``, for NVIDIA Hopper.

The JAX package ``tpu_cnn`` stays the reference; this package runs the same
fixed-point contract (uint8 activations, int8 weights, conv3x3 -> >>shift ->
clip 0..255 -> 2x2 max pool) with plain PyTorch around one hand-written CUDA
kernel:

  - ``models.cnn``        — ``TorchFpgaCNN``: the int8 kernels, shifts and
                            head as buffers on an explicit device
  - ``ops.quant``         — the contract in plain torch (the kernel's
                            reference and the CPU path)
  - ``ops.mega``          — the whole-net megakernel
                            (``csrc/mega_cnn.cu``) and its wrapper
  - ``ops.detect_head``   — the single-box head: classifier + CAM box
  - ``engine.cuda``       — ``CUDAEngine``: batched fused detect
  - ``bench_gate``        — the bench's parity gate, without JAX
  - ``apps.infer`` / ``apps.serve`` — the CLI and the HTTP service

It imports ``torch`` and the JAX-free modules of ``tpu_cnn`` (model
config, artifact codecs, numpy oracles, host head twins, the serving
layer), and never ``jax``.
"""

__version__ = "0.1.0"
