"""PyTorch/CUDA port of whisper-vits-svc synthesis for NVIDIA Hopper.

A second package beside the JAX reference (`whisper_vits_svc_tpu`). It
imports torch, numpy and scipy only. Module paths mirror the JAX package;
layouts at public functions are the JAX ones (latents [B, T, C], AMP stages
and the snake [B, C, T], audio [B, S, 1]). Entry points run on the card
unless the caller passes device="cpu".

Ported so far: features-in synthesis (`infer.pipeline.svc_infer`) with the
fused anti-aliased snake as a hand-written CUDA kernel
(`ops/snake_cuda.py`, `csrc/snake_alias.cu`).
"""
