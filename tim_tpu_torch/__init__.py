"""TIM in PyTorch for NVIDIA Hopper: the port of ``tim_tpu``.

The package mirrors ``tim_tpu``'s module paths so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``, and
nothing of ``tim_tpu``: what it needs of the JAX package's jax-free
modules (``config``, ``data``, ``evals``, the native NMS source)
it keeps as its own copies, which tests pin to the originals.

Ported so far: dense TIM detection inference over pre-extracted
features, from ``make_inference_step`` through ``serve.DetectionServer``,
in bf16 and fp32 and as int8 static serving
(``DetectionServer.quantized``); and visual feature extraction with the
Omnivore Swin-B and VideoMAE ViT-L backbones (``models.backbones``,
``extract``), their training (``runner.backbone``), and TIM detection
training and validation (``train.detection``, ``runner.detection``).
The five TPU kernels on those paths are
hand-written CUDA for ``sm_90a`` (``csrc/``), built at first use by
``_build``; on CPU tensors their wrappers run the plain PyTorch versions
beside them. Entry points run on the CUDA card unless the caller asks for
the CPU.
"""

__version__ = "0.1.0"
