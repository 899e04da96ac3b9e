"""GAN + flow losses of the SVC trainer (JAX train/losses.py; reference
vits/losses.py and the loss assembly of vits_extend/train.py:189-247).
Latents are [B, T, C], waveforms [B, T], masks [B, T, 1].

Under data parallelism (`glob`, a parallel.ddp.GlobalBatch) the flow KL and
the MR-STFT spectral convergence return this rank's share of the global
batch's term: the shares sum to the global term over the ranks, and so do
their gradients. Neither term is a mean of per-rank losses."""

from __future__ import annotations

import torch

from ..ops.stft import mel_spectrogram, stft_loss_magnitude


def kl_loss(z, logs_q, m_p, logs_p, total_logdet, z_mask, glob=None):
    """Flow KL with logdet (vits/losses.py:43-61); the divisor is the
    mask-element count only, as the reference's: the global batch's under
    `glob`."""
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * torch.square(z - m_p) * torch.exp(-2.0 * logs_p)
    kl = torch.sum(kl * z_mask) - torch.sum(total_logdet)
    count = torch.sum(z_mask)
    return kl / (count if glob is None else glob.sum(count))


def generator_adversarial_loss(disc_fake):
    """mean((score - 1)^2), averaged over discriminators (train.py:203-207)."""
    return sum(torch.mean(torch.square(score - 1.0)) for _, score in disc_fake) / len(disc_fake)


def feature_matching_loss(disc_fake, disc_real):
    """L1 feature matching on detached real fmaps, / len(disc) then x2
    (train.py:210-216)."""
    loss = sum(torch.mean(torch.abs(f - r.detach()))
               for (feat_fake, _), (feat_real, _) in zip(disc_fake, disc_real)
               for f, r in zip(feat_fake, feat_real))
    return loss / len(disc_fake) * 2.0


def discriminator_adversarial_loss(disc_fake, disc_real):
    """LSGAN D loss averaged over discriminators (train.py:239-244)."""
    loss = sum(torch.mean(torch.square(score_real - 1.0)) + torch.mean(torch.square(score_fake))
               for (_, score_fake), (_, score_real) in zip(disc_fake, disc_real))
    return loss / len(disc_fake)


def spectral_convergence(x_mag, y_mag, glob=None):
    """||Y - X||_F / ||Y||_F over the batch. Under `glob` the norms are the
    global batch's, sqrt of the ranks' summed squares (Y is data), and this
    rank's share is ||Y_r - X_r|| / ||Y|| * (||Y_r - X_r|| / ||Y - X||),
    the factor detached: the shares sum to the global ratio, and the
    gradient of a share is the global ratio's gradient for this rank's rows.
    With one rank the factor is exactly 1 (sqrt(a * a) == a in binary
    floating point) and the share is the local ratio to the bit."""
    num = torch.linalg.vector_norm(y_mag - x_mag)
    den = torch.linalg.vector_norm(y_mag)
    if glob is None:
        return num / den
    num_all = torch.sqrt(glob.sum(num.square()))
    den_all = torch.sqrt(glob.sum(den.square()))
    return num / den_all * (num.detach() / num_all)


def multi_resolution_stft_loss(fake, real, resolutions, glob=None):
    """(sc_loss, mag_loss) averaged over resolutions (stft_loss.py:97-135):
    sc = ||Y| - |X||_F / ||Y||_F, mag = L1 of the logs; under `glob` both are
    this rank's shares of the global batch's."""
    sc_loss = mag_loss = 0.0
    for n_fft, hop, win in resolutions:
        x_mag = stft_loss_magnitude(fake, n_fft, hop, win)
        y_mag = stft_loss_magnitude(real, n_fft, hop, win)
        sc_loss = sc_loss + spectral_convergence(x_mag, y_mag, glob)
        mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
        mag_loss = mag_loss + (mag if glob is None else mag / glob.world)
    n = len(resolutions)
    return sc_loss / n, mag_loss / n


def mel_l1_loss(fake, real, data_cfg):
    """TacotronSTFT mel L1 (train.py:196-199)."""
    kw = dict(n_fft=data_cfg["filter_length"], num_mels=data_cfg["mel_channels"],
              sampling_rate=data_cfg["sampling_rate"], hop=data_cfg["hop_length"],
              win_length=data_cfg["win_length"], fmin=data_cfg["mel_fmin"],
              fmax=data_cfg["mel_fmax"])
    return torch.mean(torch.abs(mel_spectrogram(fake, **kw) - mel_spectrogram(real, **kw)))


def cosine_speaker_loss(spk, spk_preds):
    """CosineEmbeddingLoss with target 1 (train.py:150, 190-192)."""
    cos = torch.sum(spk * spk_preds, dim=-1) / (
        torch.linalg.vector_norm(spk, dim=-1) * torch.linalg.vector_norm(spk_preds, dim=-1)
        + 1e-12)
    return torch.mean(1.0 - cos)
