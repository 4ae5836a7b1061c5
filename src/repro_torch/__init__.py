"""PyTorch/CUDA port of the serving plane's model step, for one NVIDIA H100.

The JAX package ``repro`` beside this one is the reference: every module
here mirrors a module there by name and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch`` and
never ``jax`` or ``repro``; the jax-free pieces it needs (the KV page pool,
the shared-memory pub/sub planes, the serving plane, the trace rings and
metrics) are copied, not imported.

* :mod:`repro_torch.configs` — ``ModelConfig`` factories and ``model_100m``;
* :mod:`repro_torch.models` — the dense transformer and the xLSTM family
  (prefill, decode) and ``Model``; :mod:`repro_torch.models.weights`
  carries a JAX parameter tree across as numpy;
* :mod:`repro_torch.kernels` — the Hopper kernels that replace the Pallas
  TPU kernels (fused residual-add + RMSNorm, flash attention, decode
  attention, the sLSTM scan and the ragged concat, all in CUDA C++ under
  ``csrc/``), each beside its plain PyTorch version;
* :mod:`repro_torch.runtime` — the continuous-batching ``InferenceServer``
  and its message ingest;
* :mod:`repro_torch.core`, :mod:`repro_torch.obs`, :mod:`repro_torch.serving`
  — the zero-copy pub/sub planes for unsized messages, the executor, the
  observability plane, and the sharded serving fleet (router, replicas,
  collector), each a copy of the reference's module of the same name;
* :mod:`repro_torch.launch.serve` — the serving entry point, and
  :mod:`repro_torch.launch.fleet` — the fleet's.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Keep this ``__init__`` import-free, like ``repro/__init__.py``.
"""
