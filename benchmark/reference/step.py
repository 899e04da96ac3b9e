"""The so-vits-svc 5.0 GAN training step in plain PyTorch
(vits_extend/train.py:170-247), frozen as the benchmark's reference.

G's loss is score + feature matching + mel L1 x c_mel + MR-STFT x c_stft +
KL(flow forward) x c_kl + KL(flow reverse) x c_kl / 2 + the GRL cosine
speaker loss x 2; D's the LSGAN loss of the same D forward on fake || real,
its gradient taken over D only. G steps AdamW on the mean of `accum_step`
calls' gradients, D every call at lr / accum_step (torch AdamW, weight
decay 1e-2, written out below).
"""

from __future__ import annotations

import torch

from .disc import Discriminator, gan_terms, kl_loss, log_mel, mr_stft_loss
from .synth import SynthesizerTrn


class AdamW:
    """torch.optim.AdamW's update, one leaf at a time."""

    def __init__(self, params, lr, betas, eps, weight_decay=1e-2):
        self.params, self.lr, self.betas, self.eps, self.wd = list(params), lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / bc2 ** 0.5 + self.eps, value=-self.lr / bc1)


def losses(hp, g_model, d_model, batch, generator):
    """(loss_g, loss_d, terms) of one step's batch."""
    tc, data = hp["train"], hp["data"]
    out = g_model(batch["ppg"], batch["vec"], batch["pit"], batch["spec"], batch["spk"],
                  batch["ppg_l"], batch["spec_l"], generator)
    fake = out["audio"]
    seg = data["segment_size"]
    audio = batch["audio"]
    start = (out["ids"] * data["hop_length"]).clamp(0, audio.shape[1] - seg)
    idx = start[:, None] + torch.arange(seg, device=audio.device)[None, :]
    real = torch.gather(audio[..., 0], 1, idx)
    mel = torch.mean(torch.abs(log_mel(fake[..., 0], data) - log_mel(real, data))) * tc["c_mel"]
    sc, mag = mr_stft_loss(fake[..., 0], real, [tuple(r) for r in hp["mrd"]["resolutions"]])
    n = fake.shape[0]
    score, feat, loss_d = gan_terms(d_model(torch.cat([fake, real[..., None]], dim=0)), n)
    kl_f = kl_loss(out["z_f"], out["logs_q"], out["m_p"], out["logs_p"], out["logdet_f"],
                   out["mask"]) * tc["c_kl"]
    kl_r = kl_loss(out["z_r"], out["logs_p"], out["m_q"], out["logs_q"], out["logdet_r"],
                   out["mask"]) * tc["c_kl"]
    spk, pred = batch["spk"], out["spk_preds"]
    cos = torch.sum(spk * pred, dim=-1) / (torch.linalg.vector_norm(spk, dim=-1)
                                           * torch.linalg.vector_norm(pred, dim=-1) + 1e-12)
    loss_i = torch.mean(1.0 - cos)
    loss_g = score + feat + mel + (sc + mag) * tc["c_stft"] + kl_f + kl_r * 0.5 + loss_i * 2.0
    return loss_g, loss_d


class TrainStep:
    """G and D with their optimizers; `__call__(batch, generator)` takes one
    step and returns (loss_g, loss_d, g_grads, d_grads), the gradients of
    this call before accumulation."""

    def __init__(self, hp, state_dict_g, state_dict_d, device):
        self.hp = hp
        self.g, self.d = SynthesizerTrn(hp).to(device), Discriminator(hp).to(device)
        self.g.load_state_dict(state_dict_g)
        self.d.load_state_dict(state_dict_d)
        tc = hp["train"]
        self.k = tc["accum_step"]
        betas = tuple(tc["betas"])
        self.opt_g = AdamW(self.g.parameters(), tc["learning_rate"], betas, tc["eps"])
        self.opt_d = AdamW(self.d.parameters(), tc["learning_rate"] / self.k, betas, tc["eps"])
        self.acc = [torch.zeros_like(p) for p in self.opt_g.params]
        self.mini = 0

    def __call__(self, batch, generator):
        loss_g, loss_d = losses(self.hp, self.g, self.d, batch, generator)
        d_grads = torch.autograd.grad(loss_d, self.opt_d.params, retain_graph=True)
        g_grads = torch.autograd.grad(loss_g, self.opt_g.params)
        with torch.no_grad():
            for a, g in zip(self.acc, g_grads):
                a.add_((g - a) / (self.mini + 1))
        self.mini = (self.mini + 1) % self.k
        if self.mini == 0:
            self.opt_g.step(self.acc)
            for a in self.acc:
                a.zero_()
        self.opt_d.step(d_grads)
        return loss_g.detach(), loss_d.detach(), g_grads, d_grads
