"""The port's streaming extractors against the JAX package's classes, with
the same weights (JAX-initialised, carried over by models/convert.py):
whisper's sliding window and HuBERT's carried context at rtol 1e-4 /
atol 1e-5; CREPE (capacity "tiny", seeded) whose flush path must equal the
port's offline Viterbi path and the JAX streaming path exactly; the
composed pitch against the offline pitch; push_audio end to end against
the JAX package at noise_scale=0."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer import stream_extract as jse
from whisper_vits_svc_tpu.infer.stream import StreamingSvc as JStreamingSvc
from whisper_vits_svc_tpu.models import crepe as jcrepe
from whisper_vits_svc_tpu.models import hubert as jhubert
from whisper_vits_svc_tpu.models import whisper as jwhisper
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer import stream_extract as se
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models import crepe as pcrepe
from whisper_vits_svc_tpu_torch.models import hubert as phubert
from whisper_vits_svc_tpu_torch.models import whisper as pwhisper
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

SR = 16000
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _perturbed(tree, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _sine(seconds, f0=220.0, glide=0.0, seed=0):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f = f0 * (1.0 + glide * t / max(seconds, 1e-9))
    phase = 2 * np.pi * np.cumsum(f) / SR
    rng = np.random.default_rng(seed)
    x = 0.5 * np.sin(phase) + 0.15 * np.sin(2 * phase)
    return (x + rng.standard_normal(n) * 0.005).astype(np.float32)


def _fit_classifier(pc) -> dict:
    """A classifier for the seeded CREPE whose output follows the pitch: a
    ridge regression of Gaussian bumps at the true bin on the seeded
    network's features of a 120-600 Hz glide. With random weights the
    Viterbi path would not move, and an equal path would say little."""
    n = 6 * SR
    f0 = np.geomspace(120.0, 600.0, n)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    noise = np.random.default_rng(11).standard_normal(n) * 0.005
    frames = pcrepe.frame_audio((0.5 * np.sin(phase) + 0.15 * np.sin(2 * phase)
                                 + noise).astype(np.float32), 160)
    feats = []
    hook = pc.classifier.register_forward_hook(
        lambda m, i, o: feats.append(i[0].detach().numpy()))
    pcrepe.crepe_probabilities(pc, frames, batch_size=512)
    hook.remove()
    x = np.concatenate(feats)[: len(frames)].astype(np.float64)
    bins = pcrepe.frequency_to_bins(f0[np.minimum(np.arange(len(frames)) * 160, n - 1)])
    target = 12.0 * np.exp(-0.5 * ((np.arange(pcrepe.PITCH_BINS)[None] - bins[:, None])
                                   / 3.0) ** 2) - 6.0
    xm, tm = x.mean(0), target.mean(0)
    xc = x - xm
    w = np.linalg.solve(xc.T @ xc + 1e-3 * np.eye(x.shape[1]), xc.T @ (target - tm))
    return dict(kernel=w.astype(np.float32), bias=(tm - xm @ w).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model) for whisper (n_state 64, 4 heads,
    2 layers), HuBERT-soft (2 layers) and CREPE "tiny" (its classifier
    fitted), all on the CPU."""
    jw = jwhisper.WhisperEncoder(n_mels=80, n_ctx=1500, n_state=64, n_head=4, n_layer=2)
    pw_params = jax.jit(jw.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1500, 80)))["params"]
    pw_params = _perturbed(pw_params, 0, 0.02)
    pw = pwhisper.WhisperEncoder(n_state=64, n_head=4, n_layer=2).eval()
    pw.load_state_dict(convert.from_jax_whisper(pw_params), strict=True)

    jh = jhubert.HubertSoft(n_layers=2)
    ph_params = jax.jit(jh.init)(jax.random.PRNGKey(1), jnp.zeros((1, 2 * SR)))["params"]
    ph_params = _perturbed(ph_params, 1, 0.05)
    ph = phubert.HubertSoft(n_layers=2).eval()
    ph.load_state_dict(convert.from_jax_hubert(ph_params), strict=True)

    jc = jcrepe.Crepe("tiny")
    pc_params = jax.tree.map(np.asarray, jax.jit(jc.init)(jax.random.PRNGKey(2),
                                                          jnp.zeros((1, 1024)))["params"])
    pc = pcrepe.Crepe("tiny").eval()
    pc.load_state_dict(convert.from_jax_crepe(pc_params), strict=True)
    pc_params["classifier"] = _fit_classifier(pc)
    pc.load_state_dict(convert.from_jax_crepe(pc_params), strict=True)
    return dict(whisper=(jw, pw_params, pw), hubert=(jh, ph_params, ph),
                crepe=(jc, pc_params, pc))


def test_stream_whisper_matches_jax(models):
    """Blocks of 3 s through the warm-up (a masked window) and past 15 s
    (the rolling window): after every push the newest window's frames
    against the JAX class's, and the bookkeeping alike."""
    jm, params, pm = models["whisper"]
    audio = (np.random.default_rng(3).standard_normal(18 * SR) * 0.2).astype(np.float32)
    ref, got = jse.StreamingWhisper(jm, params), se.StreamingWhisper(pm, device="cpu")
    block = 3 * SR
    for s in range(0, len(audio), block):
        ref.push(audio[s : s + block])
        got.push(audio[s : s + block])
        assert got._start_frame == ref._start_frame
        n = got.total // se.HOP
        lo = max(got._start_frame, n - 200)
        np.testing.assert_allclose(got.frames(lo, n), ref.frames(lo, n), **FEAT_TOL)
    assert got._start_frame == 3 * SR // se.HOP


def test_stream_hubert_matches_jax(models):
    """1 s blocks with a 2 s carried context over 5 s: the emitted frames of
    every push against the JAX class's (the window rolls from the fourth
    push on)."""
    jm, params, pm = models["hubert"]
    audio = (np.random.default_rng(4).standard_normal(5 * SR) * 0.2).astype(np.float32)
    ref = jse.StreamingHubert(jm, params, block_samples=SR, context_seconds=2.0)
    got = se.StreamingHubert(pm, block_samples=SR, context_seconds=2.0, device="cpu")
    emitted = 0
    for s in range(0, len(audio), SR):
        ref.push(audio[s : s + SR])
        got.push(audio[s : s + SR])
        n = got.total // se.HOP - 4
        np.testing.assert_allclose(got.frames(emitted, n), ref.frames(emitted, n), **FEAT_TOL)
        emitted = n
    assert got._start_frame == ref._start_frame == 2 * SR // se.HOP


def test_stream_crepe_flush_equals_offline_and_jax(models):
    """Pushed in 0.5 s blocks and finished, the trellis backtraced from the
    last frame gives the port's offline `viterbi_decode` path on the same
    audio (the trellis on the CPU) and the JAX streaming path, every frame
    exactly; one big push gives the same trellis to the bit."""
    jm, params, pm = models["crepe"]
    audio = _sine(4.0, glide=0.25, seed=3)
    got, one = se.StreamingCrepe(pm, device="cpu"), se.StreamingCrepe(pm, device="cpu")
    ref = jse.StreamingCrepe(jm, params)
    for s in range(0, len(audio), 8000):
        got.push(audio[s : s + 8000])
        ref.push(audio[s : s + 8000])
    one.push(audio)
    for sc in (got, ref, one):
        sc.finish()
    path = got.decode(0, got.head + 1)

    probs = pcrepe.crepe_probabilities(pm, pcrepe.frame_audio(audio, se.HOP), batch_size=64)
    offline = pcrepe.viterbi_decode(pcrepe.viterbi_observations(probs), device="cpu")
    assert got.head + 1 == len(offline) == len(audio) // se.HOP + 1
    assert len(np.unique(offline)) > 10  # the path follows the glide
    np.testing.assert_array_equal(path, offline)
    np.testing.assert_array_equal(path, ref.decode(0, ref.head + 1))
    np.testing.assert_array_equal(one.value, got.value)
    np.testing.assert_array_equal(one.decode(0, one.head + 1), path)


def _extractor(models, port: bool, **kw):
    kw.setdefault("block_samples", SR)
    if port:
        return se.StreamingExtractor(models["whisper"][2], models["hubert"][2],
                                     models["crepe"][2], device="cpu", **kw)
    return jse.StreamingExtractor(whisper=models["whisper"][:2], hubert=models["hubert"][:2],
                                  crepe=models["crepe"][:2], **kw)


def _run_extractor(ex, audio, block):
    outs = [ex.push(audio[s : s + block]) for s in range(0, len(audio), block)]
    outs.append(ex.flush())
    return [np.concatenate(x) for x in zip(*outs)]


def test_stream_extractor_composed_matches_offline_and_jax(models):
    """1 s blocks over 3 s. With a lag that covers the stream every frame is
    decoded from the last head at the flush: the composed 100 fps pitch
    (x2 repeat, the mean-5 filter and its edges) equals the port's offline
    compute_f0_sing (rng=None) to 1e-6 relative. At lag 4 the fixed-lag
    path may differ from offline; how far depends on the weights (the JAX
    package bounds it on the reference's trained tiny.pth, which is not
    here; on these seeded weights the JAX class departs from offline just
    as far), so at lag 4 the port is held to the JAX extractor: pitch
    exactly, PPG and units at rtol 1e-4 / atol 1e-5."""
    audio = _sine(3.0, glide=0.6, seed=3)
    n = len(audio) // se.HOP
    off = pcrepe.compute_f0_sing(models["crepe"][2], audio, rng=None)[: 2 * n]
    assert len(np.unique(np.round(off))) > 10  # the pitch follows the glide
    _, _, whole = _run_extractor(_extractor(models, True, lag_frames=n), audio, SR)
    np.testing.assert_allclose(whole, off, rtol=1e-6)

    ppg, vec, pit = _run_extractor(_extractor(models, True), audio, SR)
    assert ppg.shape == (2 * n, 64) and vec.shape == (2 * n, 256) and pit.shape == (2 * n,)

    r_ppg, r_vec, r_pit = _run_extractor(_extractor(models, False), audio, SR)
    np.testing.assert_array_equal(pit, r_pit)
    np.testing.assert_allclose(ppg, r_ppg, **FEAT_TOL)
    np.testing.assert_allclose(vec, r_vec, **FEAT_TOL)


def test_push_audio_matches_jax(models):
    """Audio in, audio out: StreamingSvc.push_audio over 2 s in 0.5 s blocks
    (50-frame synthesis blocks, 25 frames of context) and the flush,
    on the port and on the JAX package with the same synthesizer weights
    (hop 320, narrow), noise_scale=0: 2x the samples in, within 1e-4 of
    JAX's waveform (the port's svc_infer bound)."""
    hp = micro_hp()
    hp.data.update(hop_length=320, sampling_rate=32000, filter_length=256)
    hp.vits.update(ppg_dim=64, vec_dim=256)
    hp.gen.update(upsample_rates=[5, 4, 4, 2, 2], upsample_kernel_sizes=[15, 8, 8, 4, 4],
                  upsample_initial_channel=64)
    jmodel = jpipeline.build_infer_model(hp)
    t0 = 8
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t0, 64)), jnp.zeros((1, t0, 256)), jnp.full((1, t0), 200.0),
        jnp.zeros((1, hp.vits.spk_dim)), jnp.full((1,), t0, jnp.int32),
        jnp.zeros((1, t0 * 320, 1)))["params"]
    params = _perturbed(params, 6, 0.05)
    port_hp = config_from_dict(hp)
    model = pipeline.build_infer_model(port_hp, device="cpu")
    model.load_state_dict(convert.from_jax_params(params), strict=True)
    spk = (np.random.default_rng(8).standard_normal(hp.vits.spk_dim) * 0.1).astype(np.float32)

    kw = dict(block_frames=50, context_frames=25, noise_scale=0.0)
    ref = JStreamingSvc(jmodel, params, spk, hp, **kw)
    ref.attach_extractor(_extractor(models, False, block_samples=SR // 2))
    got = StreamingSvc(model, spk, port_hp, device="cpu", **kw)
    got.attach_extractor(_extractor(models, True, block_samples=SR // 2))

    audio = _sine(2.0, glide=0.6, seed=7)
    wavs = []
    for svc in (ref, got):
        out = [svc.push_audio(audio[s : s + SR // 2]) for s in range(0, len(audio), SR // 2)]
        out.append(svc.flush_audio())
        wavs.append(np.concatenate(out))
    assert wavs[1].shape == wavs[0].shape == (2 * len(audio),)
    assert np.isfinite(wavs[1]).all() and np.abs(wavs[1]).max() > 1e-3
    np.testing.assert_allclose(wavs[1], wavs[0], atol=1e-4)
