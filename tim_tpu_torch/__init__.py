"""TIM in PyTorch for NVIDIA Hopper: the port of ``tim_tpu``.

The package mirrors ``tim_tpu``'s module paths so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax``; the
jax-free parts of ``tim_tpu`` (``config``, ``data.windows``, ``evals``)
are imported from there rather than copied.

Ported so far: dense TIM detection inference over pre-extracted
features, from ``make_inference_step`` through ``serve.DetectionServer``.
The two TPU kernels on that path are hand-written CUDA for ``sm_90a``
(``csrc/``), built at first use by ``_build``; on CPU tensors their
wrappers run the plain PyTorch versions beside them.
"""

__version__ = "0.1.0"
