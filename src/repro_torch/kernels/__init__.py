"""Hopper kernels for the main path, each beside its plain PyTorch version.

* ``rmsnorm`` — fused residual add + RMSNorm, also the norm alone and
  Gemma's ``1 + scale`` (CUDA C++, ``csrc/rmsnorm.cu``); every full-width
  RMSNorm of the models goes through it; its backward ``rmsnorm_bwd`` in
  the same source;
* ``flash_attention`` — GQA prefill attention, causal or not (CUDA C++,
  ``csrc/flash_attention.cu``), and its backward ``flash_attention_bwd``
  (``csrc/flash_attention_bwd.cu``);
* ``decode_attention`` — one query per request against the KV cache,
  split over the sequence (CUDA C++, ``csrc/decode_attention.cu``);
* ``slstm_scan`` — the sLSTM time recurrence in one cooperative launch
  (CUDA C++, ``csrc/slstm_scan.cu``);
* ``ragged_concat`` — N ragged sources packed into one zero-filled buffer
  (CUDA C++, ``csrc/ragged_concat.cu``); on no model path, an operation
  of its own.

Every ``ops`` wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel or raises, and counts each launch in
its ``launches`` attribute.  Under grad, the two kernels with a backward
go through ``torch.autograd.Function``s whose backwards are kernels too.
Submodules import independently.
"""
