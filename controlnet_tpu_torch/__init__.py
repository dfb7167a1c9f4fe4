"""controlnet_tpu_torch — the PyTorch/CUDA port of ``controlnet_tpu``.

A second package beside the JAX one, which stays as the reference the port
is held against.  The layout mirrors ``controlnet_tpu/`` module for module:

  config.py              <- controlnet_tpu/config.py (own copy, no tpu_params)
  schedules/linear.py    <- controlnet_tpu/schedules/linear.py
  nn/layers.py           <- controlnet_tpu/nn/layers.py
  nn/blocks.py           <- controlnet_tpu/nn/blocks.py
  ops/attention.py       <- controlnet_tpu/ops/attention.py
  ops/cuda_attention.py  <- controlnet_tpu/ops/pallas_attention.py (fused_attention_t + VJP)
  csrc/attention_fwd.cu  <- _attn_kernel_t, hand-written CUDA for sm_90a
  csrc/attention_bwd.cu  <- _attn_bwd_kernel_t, hand-written CUDA for sm_90a
  ops/canny.py           <- controlnet_tpu/ops/canny.py
  models/unet.py         <- controlnet_tpu/models/unet.py (unconditioned)
  models/controlnet.py   <- controlnet_tpu/models/controlnet.py (DDPM hint block)
  io/jax_params.py       <- controlnet_tpu/io/torch_export.py layout rules
  io/checkpoint.py       <- controlnet_tpu/io/checkpoint.py's contract (torch.save)
  sample/ddpm.py         <- controlnet_tpu/sample/ddpm.py
  train/state.py         <- controlnet_tpu/train/state.py
  schedules/karras.py    <- controlnet_tpu/schedules/karras.py
  schedules/consistency.py <- controlnet_tpu/schedules/consistency.py
  models/consistency.py  <- controlnet_tpu/models/consistency.py
  models/dmd.py          <- controlnet_tpu/models/dmd.py
  train/loops.py         <- controlnet_tpu/train/loops.py (DDPM, ControlNet, consistency, DMD)
  utils/diffusion_utils.py <- controlnet_tpu/utils/diffusion_utils.py (image drop)
  data/datasets.py       <- controlnet_tpu/data/datasets.py (.npy arrays, iterate_batches)
  cli.py                 <- controlnet_tpu/cli.py (the trainers' helpers)
  tools/sample_ddpm_controlnet.py <- tools/sample_ddpm_controlnet.py
  tools/train_ddpm.py    <- tools/train_ddpm.py
  tools/train_ddpm_controlnet.py <- tools/train_ddpm_controlnet.py
  tools/{train,sample}_consistency_controlnet_distilled.py,
  tools/{train,sample}_distribution_matching_controlnet_distilled.py,
  tools/serve.py         <- the same files under tools/

Modules are NCHW with the reference PyTorch state-dict names, so a
reference-format ``.pth`` loads with ``load_state_dict(strict=True)``.
Nothing here imports ``jax`` or ``controlnet_tpu``; submodules are not
imported eagerly.
"""

__version__ = "0.1.0"
