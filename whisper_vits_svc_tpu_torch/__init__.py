"""PyTorch/CUDA port of whisper-vits-svc for NVIDIA Hopper.

A second package beside the JAX reference (`whisper_vits_svc_tpu`). It
imports torch, numpy and scipy only. Module paths mirror the JAX package;
layouts at public functions are the JAX ones (latents [B, T, C], AMP stages
and the snake [B, C, T], audio [B, S, 1]). Entry points run on the card
unless the caller passes device="cpu".

Ported so far: synthesis (`infer.pipeline.svc_infer`), audio in (the
whisper, HuBERT-soft, CREPE and speaker extractors under `models/`, the
retrieval banks `infer.retrieval`, and `cli.inference` from a wave file),
the GAN training step (`train.step`) and the training loop around it
(`train.loop.train`, `data/`, `train.checkpoint`, `cli.trainer`), with the
fused anti-aliased snake and its backward as hand-written CUDA kernels
(`ops/snake_cuda.py`, `csrc/snake_alias.cu`, `csrc/snake_alias_bwd.cu`).
"""
