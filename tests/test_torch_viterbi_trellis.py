"""CREPE's Viterbi trellis in the port (ops/viterbi_cuda.py,
csrc/viterbi_trellis.cu): the plain version and the stream's trellis
(infer/stream_extract.py) against a float32 numpy loop bit for bit, values
and pointers, over masked bins, planted ties, large carried values and a
value carried across calls;
the kernel's work plan (the out-of-band scores once a source, their prefix
and suffix maxima, the band walked in index order) emulated in numpy and
held to the same bits; the banded form of the transition matrix and its
refusals; the counters on the CPU. The kernel itself, and a stream on the
card, are tested where there is a card (marker `card`, skipped here)."""

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu_torch.infer import stream_extract as se
from whisper_vits_svc_tpu_torch.models import crepe
from whisper_vits_svc_tpu_torch.ops import viterbi_cuda as vc

BINS, RADIUS = vc.BINS, vc.RADIUS
MASKED = np.float32(np.log(np.float32(1e-30)))  # a masked bin's log observation


def _observations(n: int, seed: int, kind: str) -> np.ndarray:
    """[n, 360] float32 log observations as the stream makes them: a
    softmax over the bins inside [50 Hz, 1 kHz] (the rest masked), or, for
    "ties", values on a coarse grid so that many scores are exactly equal
    (rows repeated, two equal peaks)."""
    rng = np.random.default_rng(seed)
    lo, hi = int(crepe.frequency_to_bins(50.0)), int(crepe.frequency_to_bins(1000.0, np.ceil))
    if kind == "ties":
        obs = (np.round(rng.random((n, BINS)) * 4) / 4 - 3).astype(np.float32)
        obs[::3] = obs[0]
        obs[1::5, 40] = obs[1::5, 200] = 0.0
    else:
        probs = rng.random((n, BINS)).astype(np.float32) ** 8
        obs = crepe.log_observations(crepe.viterbi_observations(probs))
    obs[:, :lo] = MASKED
    obs[:, hi:] = MASKED
    return obs


def _numpy_loop(chunks: list[np.ndarray], value0: np.ndarray | None = None):
    """The trellis as a float32 numpy loop, one frame at a time, fed
    `chunks` of observations in turn, from frame 0 or, given value0, from a
    value carried at frame 0: (value, {frame: pointers})."""
    log_trans = crepe._log_transition()
    value, ptrs, t = value0, {}, 0 if value0 is None else 1
    for o in np.concatenate(chunks):
        if value is None:
            value = o + np.float32(np.log(1.0 / BINS))
        else:
            scores = value[:, None] + log_trans  # [from, to]
            ptrs[t] = scores.argmax(axis=0)
            value = scores.max(axis=0) + o
        t += 1
    return value, ptrs


def _stream(chunks: list[np.ndarray], value0: np.ndarray | None = None, device="cpu"):
    """The stream's own trellis (`StreamingCrepe._step`) fed `chunks` of
    observations in turn, from frame 0 or, given value0, from a value
    carried at frame 0: (value, {frame: pointers}) on the host."""
    sc = se.StreamingCrepe(crepe.Crepe("tiny").eval().to(device), device=device)
    if value0 is not None:
        sc.head, sc.value = 0, torch.from_numpy(value0).to(device)
    for chunk in chunks:
        sc._step(chunk)
    assert sc.best == int(np.argmax(sc.value.cpu().numpy()))
    return sc.value.cpu().numpy(), sc.ptrs


def _kernel_plan(obs: np.ndarray, value: np.ndarray | None, trans: vc.BandedTransition):
    """The kernel's arithmetic in numpy: a frame's out-of-band scores S =
    value + far once a source, the first index of the prefix and suffix
    maxima of S, then for each `to` the prefix below its band (or, with
    none, -inf at index 0), its 23 band scores in increasing `from` (-inf
    guard cells outside the bins) and the suffix above, a candidate taken
    only when strictly larger; the value the winner plus the observation."""
    src, _, _ = vc._band_index()
    guard = np.full(RADIUS + 1, -np.inf, np.float32)
    if value is None:
        value, obs = obs[0] + vc.INIT, obs[1:]
    ptrs = np.empty((len(obs), BINS), np.int64)
    for t, o in enumerate(obs):
        s = value + trans.far
        pre, suf = np.empty(BINS, np.int64), np.empty(BINS, np.int64)
        best = 0
        for k in range(BINS):
            best = k if s[k] > s[best] else best
            pre[k] = best
        best = BINS - 1
        for k in range(BINS - 1, -1, -1):
            best = k if s[k] >= s[best] else best
            suf[k] = best
        padded = np.concatenate([guard, value, guard])
        band = padded[src + RADIUS + 1] + trans.band  # [to, k], float32 adds
        new, ptr = np.empty(BINS, np.float32), ptrs[t]
        for to in range(BINS):
            bv, bi = ((s[pre[to - RADIUS - 1]], pre[to - RADIUS - 1]) if to > RADIUS
                      else (np.float32(-np.inf), 0))
            for k in range(2 * RADIUS + 1):
                if band[to, k] > bv:
                    bv, bi = band[to, k], src[to, k]
            if to + RADIUS + 1 < BINS and s[suf[to + RADIUS + 1]] > bv:
                bv, bi = s[suf[to + RADIUS + 1]], suf[to + RADIUS + 1]
            new[to], ptr[to] = np.float32(bv) + o[to], bi
        value = new
    return value, ptrs


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


CASES = ["masked", "ties"]


@pytest.mark.parametrize("kind", CASES)
def test_plain_equals_the_stream_numpy_loop(kind):
    """From frame 0 in one call of 100 frames, and carried across calls of
    50 + 50 (the stream's pushes): the plain version, the stream and the
    numpy loop give the same value and pointers to the bit."""
    obs = _observations(100, seed=1, kind=kind)
    trans = crepe.banded_transition()
    value, ptrs = vc.viterbi_trellis_plain(torch.from_numpy(obs), None, trans)
    assert value.dtype == torch.float32 and value.shape == (BINS,)
    assert ptrs.dtype == torch.int16 and ptrs.shape == (99, BINS)
    want_value, want_ptrs = _numpy_loop([obs])
    want_ptrs = np.stack([want_ptrs[t] for t in range(1, 100)])
    np.testing.assert_array_equal(_bits(value), _bits(want_value))
    np.testing.assert_array_equal(ptrs.numpy(), want_ptrs)
    for chunks in ([obs], [obs[:50], obs[50:]], [obs[:1], obs[1:37], obs[37:]]):
        got_value, got_ptrs = _stream(chunks)
        np.testing.assert_array_equal(_bits(got_value), _bits(want_value))
        np.testing.assert_array_equal(np.stack([got_ptrs[t] for t in range(1, 100)]), want_ptrs)
    value_50, ptrs_50 = vc.viterbi_trellis_plain(torch.from_numpy(obs[:50]), None, trans)
    value_100, ptrs_100 = vc.viterbi_trellis_plain(torch.from_numpy(obs[50:]), value_50, trans)
    np.testing.assert_array_equal(_bits(value_100), _bits(value))
    np.testing.assert_array_equal(torch.cat([ptrs_50, ptrs_100]).numpy(), ptrs.numpy())


@pytest.mark.parametrize("kind", CASES)
def test_plain_equals_the_stream_from_a_large_carried_value(kind):
    """A value carried far into a stream (~-8,000: a ulp of 2^-11, so that
    sources of different values round to the same score): still the numpy
    loop's bits, the first index of each tie, in the plain version and in
    the stream carried across calls of 17 + 23."""
    rng = np.random.default_rng(2)
    value0 = (-8000.0 + rng.standard_normal(BINS) * 0.01).astype(np.float32)
    obs = _observations(40, seed=3, kind=kind)
    want_value, want_ptrs = _numpy_loop([obs], value0=value0)
    value, ptrs = vc.viterbi_trellis_plain(torch.from_numpy(obs), torch.from_numpy(value0),
                                           crepe.banded_transition())
    stream_value, stream_ptrs = _stream([obs[:17], obs[17:]], value0=value0)
    for got_value, got_ptrs in ((value, dict(enumerate(ptrs.numpy(), 1))),
                                (stream_value, stream_ptrs)):
        np.testing.assert_array_equal(_bits(got_value), _bits(want_value))
        np.testing.assert_array_equal(np.stack([got_ptrs[t] for t in range(1, 41)]),
                                      np.stack([want_ptrs[t] for t in range(1, 41)]))


def _start(start: str, obs: np.ndarray, rng) -> np.ndarray | None:
    """The value a check starts from: none (the first frame), one carried,
    one carried far into a stream (~-8,000), one with -inf on the low bins,
    -inf everywhere (every score ties at -inf: the first index, 0)."""
    noise = rng.standard_normal(BINS).astype(np.float32)
    if start == "first":
        return None
    if start == "large":
        return (-8000.0 + noise * 0.01).astype(np.float32)
    value = (obs[0] + vc.INIT + noise).astype(np.float32)
    if start == "neg_inf":
        value[:200] = -np.inf
    elif start == "all_neg_inf":
        value[:] = -np.inf
    return value


STARTS = ["first", "carried", "large", "neg_inf", "all_neg_inf"]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("kind", CASES)
def test_kernel_plan_equals_plain(kind, start):
    """The kernel's decomposition, emulated, gives the plain version's
    values and pointers to the bit; where the band's sources are masked, a
    far source wins (the planted case checks that it happens)."""
    obs = _observations(24, seed=4, kind=kind)
    value0 = _start(start, obs, np.random.default_rng(5))
    trans = crepe.banded_transition()
    want_value, want_ptrs = vc.viterbi_trellis_plain(
        torch.from_numpy(obs), None if value0 is None else torch.from_numpy(value0), trans)
    value, ptrs = _kernel_plan(obs, value0, trans)
    np.testing.assert_array_equal(_bits(value), _bits(want_value))
    np.testing.assert_array_equal(ptrs, want_ptrs.numpy())
    if start == "all_neg_inf":
        assert (ptrs == 0).all() and np.isneginf(value).all()
    else:
        far = np.abs(ptrs - np.arange(BINS)[None, :]) > RADIUS
        assert far.any(), "no far source won: the out-of-band path is untested"


def test_banded_form_rebuilds_the_transition_matrix():
    """The band and the one far entry rebuild `_log_transition()` bit for
    bit; the far entry is log(1e-30) in float32; band entries outside the
    matrix hold it."""
    lt = crepe._log_transition()
    trans = vc.banded(lt)
    assert trans.band.shape == (BINS, 2 * RADIUS + 1) and trans.band.dtype == np.float32
    np.testing.assert_array_equal(trans.matrix.view(np.int32), lt.view(np.int32))
    assert trans.far.view(np.int32) == lt[0, BINS - 1].view(np.int32) == MASKED.view(np.int32)
    src, _, inside = vc._band_index()
    assert (trans.band[~inside] == trans.far).all() and (~inside).sum() == RADIUS * (RADIUS + 1)
    band, matrix = trans.on(torch.device("cpu"))
    np.testing.assert_array_equal(matrix.numpy(), lt)
    np.testing.assert_array_equal(band.numpy(), trans.band)


def test_banded_refuses_other_matrices():
    lt = crepe._log_transition()
    off = lt.copy()
    off[3, 3 + RADIUS + 1] = np.nextafter(off[3, 3 + RADIUS + 1], np.float32(0))
    wider = np.full((BINS, BINS), lt[0, BINS - 1], np.float32)
    i = np.arange(BINS)
    for d in range(-RADIUS - 1, RADIUS + 2):
        k = i[(i + d >= 0) & (i + d < BINS)]
        wider[k, k + d] = -1.0
    for bad in (off, wider):
        with pytest.raises(ValueError, match="not banded"):
            vc.banded(bad)
    for bad in (lt.astype(np.float64), lt[:-1, :-1]):
        with pytest.raises(ValueError, match="float32"):
            vc.banded(bad)


def test_cuda_entry_refuses_cpu_tensors_and_counts_nothing():
    before = vc.counts()
    obs = torch.from_numpy(_observations(3, seed=6, kind="masked"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        vc.viterbi_trellis_cuda(obs, None, crepe.banded_transition())
    assert vc.counts() == before
    vc.add_counts({"launches_trellis": 2})
    assert vc.counts() == {"launches_trellis": before["launches_trellis"] + 2}
    vc.add_counts({"launches_trellis": -2})


def test_cpu_stream_runs_no_card_frame():
    """A CPU stream runs the plain trellis: `crepe_frames` grows while
    `launches_trellis` stays where it was, and the value stays on the CPU."""
    sc = se.StreamingCrepe(crepe.Crepe("tiny").eval(), device="cpu")
    before, launches = se.counts(), vc.counts()
    sc.push(np.random.default_rng(7).standard_normal(8000).astype(np.float32) * 0.1)
    after = se.counts()
    assert after["crepe_frames"] - before["crepe_frames"] == sc.head + 1 > 0
    assert sc.value.device.type == "cpu" and vc.counts() == launches


def test_offline_trellis_keeps_the_plain_loop_on_the_cpu():
    """`crepe.viterbi_trellis` on a CPU tensor is the plain version from the
    first frame: int16 pointers of T - 1 steps, and a one-frame input gives
    no step."""
    obs = _observations(30, seed=8, kind="masked")
    value, ptrs = crepe.viterbi_trellis(torch.from_numpy(obs))
    want_value, want_ptrs = _numpy_loop([obs])
    np.testing.assert_array_equal(_bits(value), _bits(want_value))
    np.testing.assert_array_equal(ptrs.numpy(), np.stack([want_ptrs[t] for t in range(1, 30)]))
    value, ptrs = crepe.viterbi_trellis(torch.from_numpy(obs[:1]))
    assert ptrs.shape == (0, BINS)
    np.testing.assert_array_equal(_bits(value), _bits(obs[0] + vc.INIT))


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 50, 64, 2000])
@pytest.mark.parametrize("kind", CASES)
def test_card_kernel_equals_plain(card, kind, n):
    """n frames in one launch, from frame 0 and from each carried value of
    `_start`: the plain version's values and pointers to the bit, on the
    card and on the CPU; one launch a call."""
    obs = _observations(n, seed=n, kind=kind)
    rng = np.random.default_rng(n + 1)
    trans = crepe.banded_transition()
    for value0 in (_start(start, obs, rng) for start in STARTS):
        args = [(torch.from_numpy(obs).to(dev),
                 None if value0 is None else torch.from_numpy(value0).to(dev))
                for dev in (card, torch.device("cpu"))]
        launches = vc.launches_trellis
        value, ptrs = vc.viterbi_trellis(*args[0], trans)
        torch.cuda.synchronize()
        assert vc.launches_trellis == launches + 1
        assert value.is_cuda and ptrs.is_cuda and ptrs.shape == (n - (value0 is None), BINS)
        for want_value, want_ptrs in (vc.viterbi_trellis_plain(*args[0], trans),
                                      vc.viterbi_trellis_plain(*args[1], trans)):
            np.testing.assert_array_equal(_bits(value.cpu()), _bits(want_value.cpu()))
            np.testing.assert_array_equal(ptrs.cpu().numpy(), want_ptrs.cpu().numpy())


def _voice(seconds: float, seed: int) -> np.ndarray:
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    f0 = 150.0 * 2 ** (np.sin(2 * np.pi * 0.7 * t))  # a glide over two octaves
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    noise = np.random.default_rng(seed).standard_normal(n) * 0.01
    return (0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase) + noise).astype(np.float32)


@pytest.mark.card
@pytest.mark.parametrize("kind", CASES)
def test_card_stream_equals_the_cpu_stream(card, kind):
    """The same observations through a card stream (one launch a call, the
    value carried on the card) and the numpy loop, in calls of 1, 49, 50
    and 64 frames: the same value and pointers to the bit."""
    obs = _observations(164, seed=10, kind=kind)
    chunks = [obs[:1], obs[1:50], obs[50:100], obs[100:]]
    launches = vc.launches_trellis
    got_value, got_ptrs = _stream(chunks, device=card)
    assert vc.launches_trellis == launches + len(chunks)
    want_value, want_ptrs = _numpy_loop(chunks)
    np.testing.assert_array_equal(_bits(got_value), _bits(want_value))
    assert sorted(got_ptrs) == sorted(want_ptrs) == list(range(1, 164))
    for t in want_ptrs:
        np.testing.assert_array_equal(got_ptrs[t], want_ptrs[t], err_msg=f"frame {t}")


@pytest.mark.card
def test_card_stream_one_launch_a_push_and_flush_equals_offline(card):
    """A CREPE "tiny" stream on the card: one trellis launch a push (and at
    the flush), the value kept on the card; its flush path is the card's
    offline `viterbi_decode` path on the same audio, every frame."""
    torch.manual_seed(0)
    model = crepe.Crepe("tiny").eval().to(card)
    audio = _voice(4.0, seed=9)
    block = 16000
    sc = se.StreamingCrepe(model, device=card)
    for s in range(0, len(audio), block):
        before, launches = se.counts(), vc.launches_trellis
        sc.push(audio[s : s + block])
        after = se.counts()
        assert vc.launches_trellis == launches + 1
        assert after["crepe_frames"] - before["crepe_frames"] > 0 and sc.value.is_cuda
    launches = vc.launches_trellis
    sc.finish()
    assert vc.launches_trellis == launches + 1
    path = sc.decode(0, sc.head + 1)
    frames = crepe.frame_audio(audio, se.HOP)
    probs = crepe.crepe_probabilities(model, frames, batch_size=se._CREPE_BATCH)
    offline = crepe.viterbi_decode(crepe.viterbi_observations(probs), device=card)
    assert len(path) == len(frames)
    np.testing.assert_array_equal(path, offline)
