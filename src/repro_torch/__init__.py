"""PyTorch/CUDA port of the serving plane's model step and of training, for
one NVIDIA H100.

The JAX package ``repro`` beside this one is the reference: every module
here mirrors a module there by name and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch`` and
never ``jax`` or ``repro``; the jax-free pieces it needs (the KV page pool,
the shared-memory pub/sub planes, the serving plane, the trace rings and
metrics) are copied, not imported.

* :mod:`repro_torch.configs` — ``ModelConfig`` factories and ``model_100m``;
* :mod:`repro_torch.models` — every family of the reference (prefill,
  decode, and the training ``forward``/``loss_fn``) and ``Model``;
  :mod:`repro_torch.models.weights` carries a JAX parameter tree (and an
  AdamW state) across as numpy;
* :mod:`repro_torch.kernels` — the Hopper kernels that replace the Pallas
  TPU kernels (fused residual-add + RMSNorm, flash attention, decode
  attention, the sLSTM scan and the ragged concat, all in CUDA C++ under
  ``csrc/``), each beside its plain PyTorch version, with backward kernels
  for the two that training runs (the fused norm and flash attention);
* :mod:`repro_torch.runtime` — the continuous-batching ``InferenceServer``
  and its message ingest; ``runtime.trainer`` the ``Trainer``, over
  :mod:`repro_torch.optim` (AdamW, the cosine schedule),
  :mod:`repro_torch.checkpoint` and :mod:`repro_torch.data` (the data
  plane's copies and its ordered zero-copy pipeline);
* :mod:`repro_torch.sharding` — the logical-axis rules and specs, and
  named-axis collectives over a ``DeviceMesh`` (``launch.mesh.make_mesh``),
  each rank holding its block; the MoE layer's serving and
  expert-parallel branches, the error-feedback int8 gradient sum across
  pods (``optim.grad_compress``) and the trainer's mesh run on them;
* :mod:`repro_torch.core`, :mod:`repro_torch.obs`, :mod:`repro_torch.serving`
  — the zero-copy pub/sub planes for unsized messages, the executor, the
  observability plane, and the sharded serving fleet (router, replicas,
  collector), each a copy of the reference's module of the same name;
* :mod:`repro_torch.launch.serve` — the serving entry point,
  :mod:`repro_torch.launch.fleet` — the fleet's, and
  :mod:`repro_torch.launch.train` — training's.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Keep this ``__init__`` import-free, like ``repro/__init__.py``.
"""
