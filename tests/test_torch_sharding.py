"""Whisper's tensor-parallel rules in the port (parallel/sharding.py, over
torch.distributed) against the JAX package's (tests/test_whisper_sharding.py):
gloo process groups on the CPU, one process a rank, as
tests/test_torch_distributed.py runs them. A 2-rank model group and a 2 x 2
data x model grid each equal the single-process port and JAX's
WhisperEncoder within 2e-4, and with the key mask of zero-padded windows
the single-process port; a one-rank group equals the plain encoder to the
bit (its all_reduce is a copy); the split rules match JAX's PartitionSpecs
through the name map of models/convert.py::from_jax_whisper."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
from whisper_vits_svc_tpu.parallel.sharding import whisper_param_spec as j_spec
from whisper_vits_svc_tpu_torch.models.convert import from_jax_whisper
from whisper_vits_svc_tpu_torch.models.whisper import WhisperEncoder
from whisper_vits_svc_tpu_torch.parallel.sharding import whisper_param_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120
DIMS = dict(n_mels=8, n_ctx=32, n_state=64, n_head=4, n_layer=2)
GRIDS = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2)}  # (data, model)

# One rank: the encoder sharded over its model group, the batch over its
# data group. Imports the port only (no JAX).
RUNNER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, num_data, num_model, port, workdir, tag = sys.argv[1:8]
rank, world, num_data, num_model = int(rank), int(world), int(num_data), int(num_model)
torch.set_num_threads(1)
from whisper_vits_svc_tpu_torch.models.whisper import WhisperEncoder
from whisper_vits_svc_tpu_torch.parallel import sharding

dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
with open(os.path.join(workdir, "dims.json")) as f:
    model = WhisperEncoder(**json.load(f)).eval()
model.load_state_dict(torch.load(os.path.join(workdir, "weights.pt"), weights_only=True))
mel = torch.from_numpy(np.load(os.path.join(workdir, "mel.npy")))
model_group, data_group = sharding.tp_groups(num_data, num_model)
sharding.shard_whisper_params(model, model_group)
q = model.blocks[0].attn.query.weight
shapes = [list(q.shape), list(model.blocks[0].attn.out.weight.shape),
          list(model.blocks[0].attn_ln.weight.shape)]
n_frames = torch.from_numpy(np.load(os.path.join(workdir, "n_frames.npy")))
run = sharding.sharded_ppg_fn(model, data_group if num_data > 1 else None)
np.save(os.path.join(workdir, f"out_{tag}_{rank}.npy"), run(mel).numpy())
np.save(os.path.join(workdir, f"masked_{tag}_{rank}.npy"), run(mel, n_frames).numpy())
print("RESULT " + json.dumps({"rank": rank, "shapes": shapes}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's encoder and mel of tests/test_whisper_sharding.py, the port with
    the same weights, and every grid of GRIDS run at once (7 processes)."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(1234)
    mel = (rng.standard_normal((4, 64, 8)) * 0.3).astype(np.float32)
    n_frames = np.array([64, 40, 17, 64])  # zero-padded windows, as preprocessing feeds them
    mel[np.arange(64)[None, :] >= n_frames[:, None]] = 0.0
    jm = JWhisperEncoder(**DIMS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(mel))["params"]
    ref_jax = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(mel)))
    model = WhisperEncoder(**DIMS).eval()
    model.load_state_dict(from_jax_whisper(params), strict=True)
    with torch.no_grad():
        ref_port = model(torch.from_numpy(mel)).numpy()
        ref_masked = model(torch.from_numpy(mel), torch.from_numpy(n_frames)).numpy()
    torch.save(model.state_dict(), tmp / "weights.pt")
    np.save(tmp / "mel.npy", mel)
    np.save(tmp / "n_frames.npy", n_frames)
    (tmp / "dims.json").write_text(json.dumps(DIMS))
    (tmp / "runner.py").write_text(RUNNER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for tag, (nd, nm) in GRIDS.items():
        port, world = _free_port(), nd * nm
        procs += [(tag, r, subprocess.Popen(
            [sys.executable, str(tmp / "runner.py"), str(r), str(world), str(nd), str(nm),
             str(port), str(tmp), tag], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True)) for r in range(world)]
    results = {}
    try:
        for tag, r, p in procs:
            out = p.communicate(timeout=RANK_TIMEOUT_S)[0]
            assert p.returncode == 0, f"{tag} rank {r} failed:\n{out[-4000:]}"
            line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
            results[tag, r] = json.loads(line[len("RESULT "):])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return tmp, ref_jax, ref_port, ref_masked, results


@pytest.mark.parametrize("tag", ["1x2", "2x2"])
def test_tensor_parallel_matches_single_and_jax(runs, tag):
    """Every rank returns the whole batch's PPG: equal across ranks to the
    bit, and to the single-process port and JAX within 2e-4 (the row-split
    sums run in another order)."""
    tmp, ref_jax, ref_port, ref_masked, results = runs
    nd, nm = GRIDS[tag]
    for kind, ref in (("out", ref_port), ("masked", ref_masked)):
        outs = [np.load(tmp / f"{kind}_{tag}_{r}.npy") for r in range(nd * nm)]
        for out in outs[1:]:
            np.testing.assert_array_equal(out, outs[0])
        assert outs[0].shape == ref.shape == (4, 32, 64)
        np.testing.assert_allclose(outs[0], ref, rtol=2e-4, atol=2e-4)
        if kind == "out":
            np.testing.assert_allclose(outs[0], ref_jax, rtol=2e-4, atol=2e-4)
    # q column-split, out row-split, layer norms whole
    assert results[tag, 0]["shapes"] == [[64 // nm, 64], [64, 64 // nm], [64]]


def test_one_rank_group_equals_plain_encoder(runs):
    tmp, _, ref_port, ref_masked, results = runs
    np.testing.assert_array_equal(np.load(tmp / "out_1x1_0.npy"), ref_port)
    np.testing.assert_array_equal(np.load(tmp / "masked_1x1_0.npy"), ref_masked)
    assert results["1x1", 0]["shapes"] == [[64, 64], [64, 64], [64]]


def test_param_spec_rules_match_jax():
    """Each port parameter's split dimension is JAX's PartitionSpec on the
    same weight (a Linear weight is JAX's kernel transposed): q/k/v and
    mlp.0 column-split with their biases, out and mlp.2 row-split with whole
    biases, the rest replicated."""
    jm = JWhisperEncoder(**DIMS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 8)))["params"]
    sd = from_jax_whisper(params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    seen = set()
    for path, leaf in leaves:
        keys = tuple(k.key for k in path)
        spec = tuple(j_spec(keys))
        split = next((i for i, a in enumerate(spec) if a == "model"), None)
        name = _port_name(keys)
        dim = whisper_param_spec(name)
        if split is None:
            assert dim is None, name
        else:
            transposed = keys[-1] == "kernel" and np.ndim(leaf) == 2
            assert dim == (1 - split if transposed else split), name
        seen.add(name)
    assert seen == set(sd)
    assert whisper_param_spec("blocks.0.attn.query.weight") == 0
    assert whisper_param_spec("blocks.0.attn.out.weight") == 1
    assert whisper_param_spec("blocks.0.attn.out.bias") is None
    assert whisper_param_spec("blocks.1.mlp.0.bias") == 0
    assert whisper_param_spec("blocks.1.mlp.2.weight") == 1
    assert whisper_param_spec("blocks.1.attn_ln.weight") is None
    assert whisper_param_spec("conv1.weight") is None


def _port_name(keys: tuple) -> str:
    """A JAX WhisperEncoder param path -> the port's state_dict name."""
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[keys[-1]]
    parts = []
    for k in keys[:-1]:
        if k.startswith("blocks_"):
            parts += ["blocks", k[len("blocks_"):]]
        elif k in ("mlp_0", "mlp_2"):
            parts += ["mlp", k[-1]]
        else:
            parts.append(k)
    return ".".join(parts + [leaf])
