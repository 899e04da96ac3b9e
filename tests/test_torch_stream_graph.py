"""StreamingSvc's CUDA graph (infer/stream.py): on the CPU the push runs op
by op, unchanged to the bit, and counts eager forwards; the graph's key
follows where the parameters lie; the graph's plumbing (static buffers, one
capture shared by the streams of a model, the lock, the kernel counts a
replay adds) with an eager stand-in for the CUDA calls. On the card (marker
`card`, skipped without one): replays equal eager pushes to the bit, two
streams share one capture, and a replay launches the 91 B1 kernels.

The file imports neither JAX nor the JAX package, so that the card's tests
run where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stream_graph.py
"""

import copy
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer import stream
from whisper_vits_svc_tpu_torch.infer.stream import StreamingSvc, graph_key, tensor_dicts
from whisper_vits_svc_tpu_torch.ops import amp_cuda, snake_cuda
from whisper_vits_svc_tpu_torch.utils import counters as registry
from whisper_vits_svc_tpu_torch.utils.config import BASE_MODEL_CONFIG, config_from_dict

BLOCK, CONTEXT = 10, 5


def micro_config():
    """BASE_MODEL_CONFIG with every width and depth cut (hop 8)."""
    cfg = copy.deepcopy(BASE_MODEL_CONFIG)
    cfg["data"].update(sampling_rate=3200, hop_length=8)
    cfg["vits"].update(ppg_dim=16, vec_dim=8, spk_dim=8, gin_channels=8, inter_channels=4,
                       hidden_channels=8, filter_channels=16, enc_p_layers=1,
                       flow_wn_layers=1, n_flows=1)
    cfg["gen"].update(upsample_input=4, upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
                      upsample_initial_channel=8, resblock_kernel_sizes=[3],
                      resblock_dilation_sizes=[[1]])
    return config_from_dict(cfg)


@pytest.fixture(scope="module")
def micro():
    hp = micro_config()
    return hp, pipeline.build_infer_model(hp, device="cpu", seed=3)


def features(hp, t, seed=5):
    rng = np.random.default_rng(seed)
    pit = rng.uniform(100, 400, t).astype(np.float32)
    pit[12:17] = 0.0  # an unvoiced run across a block seam
    return dict(spk=rng.standard_normal(hp.vits.spk_dim).astype(np.float32) * 0.5,
                ppg=(rng.standard_normal((t, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
                vec=(rng.standard_normal((t, hp.vits.vec_dim)) * 0.5).astype(np.float32),
                pit=pit)


def sizes(t, block):
    return [min(block, t - s) for s in range(0, t, block)]


def push_all(svc, f, block):
    out, s = [], 0
    for n in sizes(len(f["pit"]), block):
        out.append(svc.push(f["ppg"][s : s + n], f["vec"][s : s + n], f["pit"][s : s + n]))
        s += n
    return out


def eager_reference(model, hp, f, block, context, noise_scale, seed, device):
    """The push as it ran before the graph: pad, concatenate with the
    context, draw the noise on the host, copy to the device, the
    excitation (the stream's own `_source`, which carries the phase), one
    forward, read back."""
    hop = hp.data.hop_length
    ref = StreamingSvc(model, f["spk"], hp, block, context, noise_scale, seed, device)
    ctx = {k: np.zeros((context,) + f[k].shape[1:], np.float32) for k in ("ppg", "vec", "pit")}
    outs, s = [], 0
    for n in sizes(len(f["pit"]), block):
        full = {k: np.concatenate([ctx[k], np.pad(f[k][s : s + n],
                                                  [(0, block - n)] + [(0, 0)] * (f[k].ndim - 1))])
                for k in ctx}
        noise = None
        if noise_scale != 0:
            noise = torch.randn((1, context + block, model.inter_channels),
                                generator=ref.noise_gen).to(device)
        with torch.inference_mode():
            t = {k: torch.from_numpy(v)[None].to(device) for k, v in full.items()}
            source, ref.phase = ref._source(t["pit"])
            out = model(t["ppg"], t["vec"], t["pit"], ref.spk,
                        torch.tensor([context + block], device=device), source, noise_scale,
                        noise=noise)
            outs.append(out[0, context * hop :, 0].cpu().numpy()[: n * hop])
        ctx = {k: v[-context:] for k, v in full.items()}
        s += n
    return outs


def counters():
    return stream.graph_captures, stream.graph_replays, stream.eager_forwards


@pytest.mark.parametrize("noise_scale", [1.0, 0.0])
def test_cpu_push_is_eager_and_unchanged(micro, noise_scale):
    """Three whole blocks and a short one on the CPU: four eager forwards,
    no capture or replay, each block equal to the pre-graph push to the bit."""
    hp, model = micro
    f = features(hp, 3 * BLOCK + 4)
    c0 = counters()
    svc = StreamingSvc(model, f["spk"], hp, BLOCK, CONTEXT, noise_scale, 7, "cpu")
    got = push_all(svc, f, BLOCK)
    c1 = counters()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (0, 0, 4)
    want = eager_reference(model, hp, f, BLOCK, CONTEXT, noise_scale, 7, "cpu")
    assert [len(a) for a in got] == [BLOCK * 8] * 3 + [4 * 8]
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"block {k}")


def test_graph_key_follows_parameter_storage():
    """The key changes when a parameter's storage is replaced
    (load_state_dict(assign=True), .to(another dtype)), also when read
    through dicts listed before; it stays after an in-place load. The
    window and the noise scale pick the graph."""
    model = pipeline.build_infer_model(micro_config(), device="cpu", seed=3)
    dicts = tensor_dicts(model)
    key = graph_key(model, CONTEXT, BLOCK, 1.0)
    assert graph_key(model, CONTEXT, BLOCK, 1.0, dicts) == key
    assert key[:3] == (CONTEXT, BLOCK, 1.0) and key[3] == torch.float32
    assert len(key[4]) == len(list(model.parameters())) + len(list(model.buffers()))

    sd = {k: v.clone() + 1.0 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    assert graph_key(model, CONTEXT, BLOCK, 1.0, dicts) == key
    model.load_state_dict(sd, assign=True)
    moved = graph_key(model, CONTEXT, BLOCK, 1.0, dicts)
    assert moved[:4] == key[:4] and moved[4] != key[4]
    assert graph_key(model, CONTEXT, BLOCK, 1.0) == moved
    model.to(torch.float64)
    assert graph_key(model, CONTEXT, BLOCK, 1.0, dicts)[3:] != moved[3:]
    assert graph_key(model, CONTEXT, BLOCK, 0.0)[:3] != graph_key(model, CONTEXT, BLOCK, 1.0)[:3]
    assert graph_key(model, CONTEXT, 2 * BLOCK, 1.0)[:3] != graph_key(model, CONTEXT, BLOCK,
                                                                       1.0)[:3]


@pytest.mark.parametrize("module", [snake_cuda, amp_cuda],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_kernel_counts_add_by_name(module, monkeypatch):
    """A kernel module's `add_counts` adds to the counters that `counts`
    reads, by name; the registry's `counts`, `since` and `add_counts` read,
    diff and add them, as a replay and a capture's roll-back use them."""
    for name in module.counts():
        monkeypatch.setattr(module, name, 5)
    module.add_counts(dict.fromkeys(module.counts(), 2))
    assert module.counts() == dict.fromkeys(module.counts(), 7)
    before = registry.counts()
    assert before[module.__name__] == module.counts()
    registry.add_counts({module.__name__: {"launches": 3}})
    assert registry.since(before) == {module.__name__: {"launches": 3}}
    registry.add_counts(registry.since(before), sign=-1)
    assert registry.counts() == before and registry.since(before) == {}
    module.add_counts({name: -n for name, n in module.counts().items()})
    assert set(module.counts().values()) == {0}


LAUNCHES = 3  # stand-in kernel launches a forward


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on the CPU: the warm-up and the capture run the forward op by
    op, and a replay reruns it into the captured output without touching
    the launch counters, as a real replay skips them. Each forward counts
    LAUNCHES snake launches, as the card's forward counts its B1's."""
    monkeypatch.setattr(stream, "_graphed", lambda dev: True)
    monkeypatch.setattr(snake_cuda, "launches", 0)

    def warm(fn, dev):
        for _ in range(stream.WARM_FORWARDS):
            fn()

    def capture(fn, dev):
        out = fn()

        def replay():
            saved = snake_cuda.launches
            out.copy_(fn())
            snake_cuda.launches = saved

        return SimpleNamespace(replay=replay), out

    monkeypatch.setattr(stream, "_warm", warm)
    monkeypatch.setattr(stream, "_capture", capture)
    hp = micro_config()
    model = pipeline.build_infer_model(hp, device="cpu", seed=4)

    def count(module, args):
        snake_cuda.launches += LAUNCHES

    handle = model.register_forward_pre_hook(count)
    yield hp, model
    handle.remove()


@pytest.mark.parametrize("noise_scale", [1.0, 0.0])
def test_stand_in_graph_equals_eager(stand_in, noise_scale):
    """Through the static buffers and the replay: every block (the last
    short) equal to the eager push to the bit; one capture, a replay a
    push, no eager forward; the launch count is the warm-up's plus the
    capture's count once a replay."""
    hp, model = stand_in
    f = features(hp, 5 * BLOCK + 3, seed=8)
    c0 = counters()
    got = push_all(StreamingSvc(model, f["spk"], hp, BLOCK, CONTEXT, noise_scale, 9, "cpu"),
                   f, BLOCK)
    c1 = counters()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 6, 0)
    assert snake_cuda.launches == LAUNCHES * (stream.WARM_FORWARDS + 6)
    (g,) = stream._graphs[model].values()
    assert g.launches == {snake_cuda.__name__: {"launches": LAUNCHES}}
    assert (g.noise is None) == (noise_scale == 0)
    want = eager_reference(model, hp, f, BLOCK, CONTEXT, noise_scale, 9, "cpu")
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"block {k}")


def test_stand_in_streams_share_one_capture(stand_in):
    """Two streams of one model, other speakers and seeds, pushed in turns:
    one capture between them, each stream equal to its own eager run."""
    hp, model = stand_in
    f1, f2 = features(hp, 4 * BLOCK, seed=10), features(hp, 4 * BLOCK, seed=11)
    c0 = counters()
    a = StreamingSvc(model, f1["spk"], hp, BLOCK, CONTEXT, 1.0, 1, "cpu")
    b = StreamingSvc(model, f2["spk"], hp, BLOCK, CONTEXT, 1.0, 2, "cpu")
    got_a, got_b = [], []
    for k in range(4):
        sl = slice(k * BLOCK, (k + 1) * BLOCK)
        got_a.append(a.push(f1["ppg"][sl], f1["vec"][sl], f1["pit"][sl]))
        got_b.append(b.push(f2["ppg"][sl], f2["vec"][sl], f2["pit"][sl]))
    c1 = counters()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 8, 0)
    for got, f, seed in ((got_a, f1, 1), (got_b, f2, 2)):
        want = eager_reference(model, hp, f, BLOCK, CONTEXT, 1.0, seed, "cpu")
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_stand_in_threads_take_turns(stand_in):
    """More streams of one model than cores, a thread each, the interpreter
    switching threads every microsecond: the lock keeps each stream's
    blocks equal to its own eager run."""
    hp, model = stand_in
    n = (os.cpu_count() or 4) + 1
    feats = [features(hp, 4 * BLOCK, seed=20 + i) for i in range(n)]
    results: dict = {}

    def run(i):
        svc = StreamingSvc(model, feats[i]["spk"], hp, BLOCK, CONTEXT, 1.0, 30 + i, "cpu")
        results[i] = push_all(svc, feats[i], BLOCK)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(results) == list(range(n))
    for i in range(n):
        want = eager_reference(model, hp, feats[i], BLOCK, CONTEXT, 1.0, 30 + i, "cpu")
        for x, y in zip(results[i], want):
            np.testing.assert_array_equal(x, y)


def test_stand_in_recaptures_after_parameters_move(stand_in):
    """An in-place load keeps the capture and its output follows the new
    weights; load_state_dict(assign=True) captures again."""
    hp, model = stand_in
    f = features(hp, 3 * BLOCK, seed=12)
    svc = StreamingSvc(model, f["spk"], hp, BLOCK, CONTEXT, 0.0, 0, "cpu")
    svc.push(f["ppg"][:BLOCK], f["vec"][:BLOCK], f["pit"][:BLOCK])
    captures = stream.graph_captures
    sd = {k: v * 0.9 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    svc.push(f["ppg"][:BLOCK], f["vec"][:BLOCK], f["pit"][:BLOCK])
    assert stream.graph_captures == captures
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    svc.push(f["ppg"][:BLOCK], f["vec"][:BLOCK], f["pit"][:BLOCK])
    assert stream.graph_captures == captures + 1
    got = push_all(StreamingSvc(model, f["spk"], hp, BLOCK, CONTEXT, 0.0, 0, "cpu"), f, BLOCK)
    want = eager_reference(model, hp, f, BLOCK, CONTEXT, 0.0, 0, "cpu")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_failed_capture_runs_eagerly_and_says_so(stand_in, monkeypatch, caplog):
    """A capture that raises: that push and every later one run op by op,
    counted as eager, equal to the eager push; the error is logged once."""
    hp, model = stand_in

    def refuse(fn, dev):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(stream, "_capture", refuse)
    f = features(hp, 3 * BLOCK + 2, seed=13)
    c0 = counters()
    with caplog.at_level("WARNING", logger=stream.__name__):
        got = push_all(StreamingSvc(model, f["spk"], hp, BLOCK, CONTEXT, 1.0, 5, "cpu"), f,
                       BLOCK)
    c1 = counters()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (0, 0, 4)
    logged = [r.getMessage() for r in caplog.records if r.name == stream.__name__]
    assert len(logged) == 1 and "operation not permitted" in logged[0]
    want = eager_reference(model, hp, f, BLOCK, CONTEXT, 1.0, 5, "cpu")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def card():
    """The base-width inference model on the card, or a skip; cuDNN held to
    deterministic algorithms meanwhile. By default the generator's
    transposed convolutions take a nondeterministic one, so that two eager
    forwards of the same window differ by ~3e-7: neither side could then be
    compared with the other to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    hp = config_from_dict(BASE_MODEL_CONFIG)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield hp, pipeline.build_infer_model(hp, device="cuda", seed=0)
    finally:
        torch.backends.cudnn.deterministic = saved


CARD_BLOCK, CARD_CONTEXT = 100, 50


@pytest.mark.card
@pytest.mark.parametrize("noise_scale", [1.0, 0.0])
def test_card_replay_equals_eager(card, noise_scale):
    """12 blocks at base width, the last short: every replayed block equal
    to the eager push to the bit (and the eager run to itself); one
    capture, a replay a push."""
    hp, model = card
    f = features(hp, 11 * CARD_BLOCK + 37, seed=40)
    c0 = counters()
    got = push_all(StreamingSvc(model, f["spk"], hp, CARD_BLOCK, CARD_CONTEXT, noise_scale, 3),
                   f, CARD_BLOCK)
    c1 = counters()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 12, 0)
    want = eager_reference(model, hp, f, CARD_BLOCK, CARD_CONTEXT, noise_scale, 3, "cuda")
    again = eager_reference(model, hp, f, CARD_BLOCK, CARD_CONTEXT, noise_scale, 3, "cuda")
    assert len(got) == len(want) == 12 and len(got[-1]) == 37 * hp.data.hop_length
    for k, (a, b, c) in enumerate(zip(got, want, again)):
        np.testing.assert_array_equal(b, c, err_msg=f"eager block {k}")
        np.testing.assert_array_equal(a, b, err_msg=f"block {k}")


@pytest.mark.card
def test_card_streams_share_one_capture(card):
    """A second stream of the model and window reuses the graph (no
    capture); two streams pushed in turns each equal their eager run."""
    hp, model = card
    f1, f2 = features(hp, 4 * CARD_BLOCK, seed=41), features(hp, 4 * CARD_BLOCK, seed=42)
    a = StreamingSvc(model, f1["spk"], hp, CARD_BLOCK, CARD_CONTEXT, 0.5, 1)
    a.push(f1["ppg"][:1], f1["vec"][:1], f1["pit"][:1])  # captures
    a = StreamingSvc(model, f1["spk"], hp, CARD_BLOCK, CARD_CONTEXT, 0.5, 1)
    b = StreamingSvc(model, f2["spk"], hp, CARD_BLOCK, CARD_CONTEXT, 0.5, 2)
    captures = stream.graph_captures
    got_a, got_b = [], []
    for k in range(4):
        sl = slice(k * CARD_BLOCK, (k + 1) * CARD_BLOCK)
        got_a.append(a.push(f1["ppg"][sl], f1["vec"][sl], f1["pit"][sl]))
        got_b.append(b.push(f2["ppg"][sl], f2["vec"][sl], f2["pit"][sl]))
    assert stream.graph_captures == captures
    for got, f, seed in ((got_a, f1, 1), (got_b, f2, 2)):
        want = eager_reference(model, hp, f, CARD_BLOCK, CARD_CONTEXT, 0.5, seed, "cuda")
        for k, (x, y) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(x, y, err_msg=f"block {k}")


@pytest.mark.card
def test_card_replay_counts_91_b1_launches(card):
    """The capture records the 91 direct B1 launches of a window's forward
    and nothing else; each replay adds them to the counter."""
    hp, model = card
    f = features(hp, 4 * CARD_BLOCK, seed=43)
    svc = StreamingSvc(model, f["spk"], hp, CARD_BLOCK, CARD_CONTEXT, 0.25, 4)
    svc.push(f["ppg"][:CARD_BLOCK], f["vec"][:CARD_BLOCK], f["pit"][:CARD_BLOCK])
    g = stream._graphs[model][(CARD_CONTEXT, CARD_BLOCK, 0.25)]
    assert g.launches == {snake_cuda.__name__: {"launches": 91}}
    n0, r0 = snake_cuda.launches, stream.graph_replays
    for k in range(1, 4):
        sl = slice(k * CARD_BLOCK, (k + 1) * CARD_BLOCK)
        svc.push(f["ppg"][sl], f["vec"][sl], f["pit"][sl])
    assert stream.graph_replays - r0 == 3 and snake_cuda.launches - n0 == 3 * 91
