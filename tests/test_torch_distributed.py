"""Data-parallel training in the port (parallel/ddp.py, torch.distributed):
the rank-sharded BucketBatcher against the JAX package's to the bit; two
gloo processes on the CPU taking one step of the global batch (gradients
equal on both ranks to the bit, and equal to one process's step on the
concatenated batch) and then two loop steps through `train` with
`hp.dist` (the same parameters on both ranks, a checkpoint from rank 0
only)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_train_loop import _make_data
from whisper_vits_svc_tpu.data import dataset as jdataset
from whisper_vits_svc_tpu.utils.testing import micro_hp, synthetic_batch
from whisper_vits_svc_tpu_torch.data import dataset
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120
STEP_SEED = 5

# One rank: a step's global gradients, then two loop steps. Imports the port
# only (no JAX).
RUNNER = r"""
import json, os, sys
import numpy as np
import torch
rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
# rank 0's writer keeps its JSONL records only, as on a machine without
# tensorboard (whose import takes ~20 s here)
sys.modules["torch.utils.tensorboard"] = None
from whisper_vits_svc_tpu_torch.parallel import ddp
from whisper_vits_svc_tpu_torch.train import loop, step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

with open(os.path.join(workdir, "hp.json")) as f:
    hp = config_from_dict(json.load(f))
dev = ddp.initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
assert (ddp.world_size(), ddp.rank(), dev.type) == (2, rank, "cpu")

g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
glob = np.load(os.path.join(workdir, "batch.npz"))
b = len(glob["spk"]) // 2
batch = {k: v[rank * b : (rank + 1) * b] for k, v in glob.items()}
g, d, metrics = tstep.global_grads(hp, g_state.model, d_state.model, batch,
                                   torch.Generator().manual_seed(STEP_SEED), ddp.GlobalBatch())
np.savez(os.path.join(workdir, f"grads{rank}.npz"),
         g=torch.cat([t.reshape(-1) for t in g]).numpy(),
         d=torch.cat([t.reshape(-1) for t in d]).numpy(),
         **{"m_" + k: v.numpy() for k, v in metrics.items()})

hp["dist"] = dict(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank)
hp["log"]["log_dir"] = os.path.join(workdir, f"logs{rank}")
g_state, d_state, n = loop.train(hp, "dist", max_epochs=2, max_steps=2, device="cpu")
params = torch.cat([p.detach().reshape(-1) for p in (*g_state.params, *d_state.params)])
np.save(os.path.join(workdir, f"params{rank}.npy"), params.numpy())
print("RESULT " + json.dumps({"rank": rank, "step": n}), flush=True)
ddp.shutdown()
""".replace("STEP_SEED", str(STEP_SEED))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _hp(tmp_path):
    _, fl, jhp = _make_data(tmp_path, np.random.default_rng(1234), micro_hp())
    val = tmp_path / "valid.txt"
    val.write_text(fl.read_text().splitlines()[0])
    jhp["data"]["training_files"] = str(fl)
    jhp["data"]["validation_files"] = str(val)
    jhp["train"]["pretrain"] = ""
    jhp["train"]["epochs"] = 10000
    jhp["log"] = dict(info_interval=1, eval_interval=1, save_interval=1, num_audio=0,
                      pth_dir=str(tmp_path / "chkpt"), log_dir=str(tmp_path / "logs"),
                      keep_ckpts=0)
    return jhp


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Runs RUNNER as ranks 0 and 1 of a gloo group on localhost; each rank
    gets its own time limit, so a hung rendezvous fails the test."""
    tmp = tmp_path_factory.mktemp("ddp")
    jhp = _hp(tmp)
    (tmp / "hp.json").write_text(json.dumps(jhp))
    hp = config_from_dict(jhp)
    batch = synthetic_batch(hp, np.random.default_rng(9), b=4, t=40)
    np.savez(tmp / "batch.npz", **batch)
    (tmp / "runner.py").write_text(RUNNER)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(tmp / "runner.py"), str(r), str(port),
                               str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                rec = json.loads(line[len("RESULT "):])
                results[rec["rank"]] = rec
    return tmp, hp, batch, results


def test_bucket_batcher_rank_sharding_equals_jax(tmp_path):
    """Two replicas of batch 2: each rank's batches equal the JAX batcher's
    for that rank to the bit, key by key, in two epochs; the ranks take
    disjoint rows of one bucket per step and together cover every item."""
    _, fl, jhp = _make_data(tmp_path, np.random.default_rng(1234), micro_hp())
    hp = config_from_dict(jhp)
    ds, jds = dataset.SvcDataset(str(fl), hp.data), jdataset.SvcDataset(str(fl), jhp.data)
    boundaries = dataset.boundaries_for(hp.data)
    for epoch in (1, 2):
        per_rank = []
        for r in range(2):
            got = list(dataset.BucketBatcher(ds, 2, boundaries, num_replicas=2, rank=r,
                                             seed=7).epoch_batches(epoch))
            ref = list(jdataset.BucketBatcher(jds, 2, boundaries, num_replicas=2, rank=r,
                                              seed=7).epoch_batches(epoch))
            assert len(got) == len(ref) == dataset.BucketBatcher(
                ds, 2, boundaries, num_replicas=2, rank=r).batches_per_epoch() > 0
            for b, jb in zip(got, ref):
                assert sorted(b) == sorted(jb)
                for k in jb:
                    assert b[k].dtype == jb[k].dtype
                    np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
            per_rank.append(got)
        for b0, b1 in zip(*per_rank):
            assert b0["ppg"].shape == b1["ppg"].shape  # one bucket per step
        keys = {round(float(s), 4) for got in per_rank for b in got for s in b["spk"].sum(1)}
        assert keys == {round(float(ds.get(i)["spk"].sum()), 4) for i in range(len(ds))}


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_two_rank_step_equals_one_process_step(two_ranks):
    """The gradients of the global batch (4 utterances, 2 a rank): equal on
    both ranks to the bit, and equal to one process's gradients of the
    concatenated batch from the same generator within 1e-5 relative L2 (G
    and D each; the sums run in another order; one thread on both sides, as
    the CPU's thread count alone moves G's float32 gradients by ~4e-5); the
    reported metrics are the global ones on both ranks."""
    tmp, hp, batch, _ = two_ranks
    r0, r1 = (np.load(tmp / f"grads{r}.npz") for r in range(2))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the CPU's float32 sums move with it
    try:
        g, d, metrics = tstep.global_grads(hp, g_state.model, d_state.model, batch,
                                           torch.Generator().manual_seed(STEP_SEED))
    finally:
        torch.set_num_threads(threads)
    ref_g = torch.cat([t.reshape(-1) for t in g]).numpy()
    ref_d = torch.cat([t.reshape(-1) for t in d]).numpy()
    assert _rel_l2(r0["g"], ref_g) <= 1e-5, _rel_l2(r0["g"], ref_g)
    assert _rel_l2(r0["d"], ref_d) <= 1e-5, _rel_l2(r0["d"], ref_d)
    for k, v in metrics.items():
        np.testing.assert_allclose(r0["m_" + k], v.numpy(), rtol=1e-5, err_msg=k)


def test_two_rank_loop_keeps_ranks_equal(two_ranks):
    """Two loop steps through `train` with hp.dist: both ranks end at step
    2 with the same parameters to the bit; only rank 0 writes checkpoints
    and logs."""
    tmp, _, _, results = two_ranks
    assert set(results) == {0, 1}
    assert results[0]["step"] == results[1]["step"] == 2
    np.testing.assert_array_equal(np.load(tmp / "params0.npy"), np.load(tmp / "params1.npy"))
    ckpts = sorted(os.listdir(tmp / "chkpt" / "dist"))
    assert ckpts and all(f.endswith(".pth") for f in ckpts)
    assert os.path.isdir(tmp / "logs0" / "dist") and not os.path.exists(tmp / "logs1")
