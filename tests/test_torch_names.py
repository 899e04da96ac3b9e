"""Every public top-level function and class of the JAX package has a
counterpart of the same name in the port's module of the same path, except
the JAX-only names below (each with its reason; ROADMAP.md lists them
too). The walk reads the sources with `ast`, so it needs neither package
importable."""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "whisper_vits_svc_tpu")
PORT_PKG = os.path.join(REPO, "whisper_vits_svc_tpu_torch")

_TO_FLAX = ("converts a reference torch state_dict into a flax tree; the port's "
            "modules load the reference state_dict as it is (models/convert.py "
            "holds the inverse, from_jax_*)")
JAX_ONLY = {
    "ops/pallas_snake.py": dict.fromkeys(
        ("snake_alias_cm_pallas", "snake_alias_cm_pallas_bwd", "snake_alias_cm_pallas_diff",
         "snake_range", "use_pallas_for"),
        "Pallas kernels and their dispatch; the port's are csrc/*.cu behind "
        "ops/snake_cuda.py"),
    "ops/pallas_amp.py": dict.fromkeys(
        ("amp_iter", "amp_iter_ref", "use_fused_iter"),
        "the Pallas fused AMP iteration; the port's is csrc/amp_iter.cu behind "
        "ops/amp_cuda.py::amp_iter"),
    "parallel/mesh.py": dict.fromkeys(
        ("batch_sharding", "create_mesh", "initialize_distributed", "is_primary",
         "replicate", "replicated", "shard_batch"),
        "a jax.sharding Mesh over the TPU's devices; the port runs one process "
        "a card under torch.distributed (parallel/ddp.py)"),
    "utils/compile_cache.py": {"enable_compile_cache": "XLA's persistent compilation "
                               "cache; eager PyTorch compiles nothing"},
    "utils/testing.py": dict.fromkeys(
        ("micro_hp", "synthetic_batch", "tiny_hp"),
        "the JAX package's test configurations; the port's tests import them"),
    "models/convert.py": dict.fromkeys(
        ("conv1d", "dense", "dense_from_conv1x1", "discriminator", "layer_norm",
         "merge_into", "posterior_encoder", "speaker_classifier", "synthesizer_infer",
         "synthesizer_trn", "wn_conv1d", "wn_conv2d", "wn_convT1d", "wn_params"), _TO_FLAX),
    "models/crepe.py": {"convert_crepe": _TO_FLAX},
    "models/hubert.py": {"convert_hubert": _TO_FLAX},
    "models/whisper.py": {"convert_encoder": _TO_FLAX},
    "models/speaker_encoder.py": {
        "convert_speaker_encoder": _TO_FLAX,
        "LSTMCellScan": "a flax LSTM cell scanned over time; the port uses torch.nn.LSTM"},
    "nn/conv.py": {
        "Dense": "a flax dense layer; the port uses torch.nn.Linear",
        "declare_nct_wn_conv": "declares flax parameters for the Pallas AMP kernel; "
                               "the port's Conv1d.kernel() gives that kernel"},
    "train/step.py": {"Stepper": "bundles flax modules with their states; the port's "
                                 "modules hold their own parameters (init_train_states)"},
}


def _defined(path: str, with_imports: bool) -> set[str]:
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif with_imports and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _walk() -> dict[str, set[str]]:
    """JAX module path -> its public names with no port counterpart."""
    missing = {}
    for root, _, files in os.walk(JAX_PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, name), JAX_PKG)
            public = {n for n in _defined(os.path.join(JAX_PKG, rel), False)
                      if not n.startswith("_")}
            port = os.path.join(PORT_PKG, rel)
            have = _defined(port, True) if os.path.isfile(port) else set()
            if public - have:
                missing[rel] = public - have
    return missing


def test_every_jax_name_has_a_port_counterpart():
    missing = _walk()
    assert set(missing) == set(JAX_ONLY), sorted(set(missing) ^ set(JAX_ONLY))
    for rel, names in missing.items():
        assert names == set(JAX_ONLY[rel]), (rel, sorted(names ^ set(JAX_ONLY[rel])))
    assert all(reason for reasons in JAX_ONLY.values() for reason in reasons.values())


def test_the_walk_sees_the_names_of_this_round():
    """The names the walk once missed are ported now, each where its JAX
    module has it."""
    for rel, name in (("models/discriminator.py", "MelspecDiscriminator"),
                      ("nn/conv.py", "fold_weight_norm"), ("utils/profiling.py", "StepTimer"),
                      ("utils/profiling.py", "trace"), ("utils/profiling.py", "annotate"),
                      ("utils/device_trace.py", "measure_device_ms"),
                      ("utils/device_trace.py", "measure_device_total_ms"),
                      ("utils/device_trace.py", "device_ms_per_call"),
                      ("utils/device_trace.py", "device_total_ms"),
                      ("infer/pipeline.py", "source2wav"), ("nn/grl.py", "gradient_reversal"),
                      ("nn/wn.py", "gated_activation"), ("nn/flow.py", "flip"),
                      ("nn/snake.py", "upsample1d"), ("nn/snake.py", "downsample1d"),
                      ("nn/snake.py", "snake_alias_fused"),
                      ("data/native_loader.py", "load_npy_native"),
                      ("infer/retrieval.py", "IRetrieval")):
        assert name in _defined(os.path.join(PORT_PKG, rel), False), (rel, name)
        assert name in _defined(os.path.join(JAX_PKG, rel), False), (rel, name)
