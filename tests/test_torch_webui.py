"""The port's WebUI (cli/webui.py) and config edit (utils/config.py) against the
JAX package's: the four cases of tests/test_webui.py on the port (the zh/en
i18n chain, the comment-keeping config edit, the train config from the form,
the HTTP surface), the edit byte-equal to JAX's on configs/base.yaml, the
`.json` route rewriting only the named keys, and an export job run through
POST /export on a CPU server."""

import json
import os
import threading
import time
import urllib.parse
import urllib.request

import pytest
import torch

from whisper_vits_svc_tpu.cli import webui as jwebui
from whisper_vits_svc_tpu.utils.config import edit_config_file as j_edit_config_file
from whisper_vits_svc_tpu_torch.cli import webui
from whisper_vits_svc_tpu_torch.cli.webui import I18n, STRINGS, create_train_config
from whisper_vits_svc_tpu_torch.utils.config import (
    BASE_MODEL_CONFIG, dump_config, edit_config_file, load_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "base.yaml")
UPDATES = {"train": {"learning_rate": 1.5e-4, "batch_size": 4, "model": "mymodel",
                     "pretrain": "vits_pretrain/sovits5.0.pretrain.pth", "nan_guard": False},
           "log": {"info_interval": 50, "keep_ckpts": 3}}


def test_i18n_languages_complete_and_fallback():
    zh, en = I18n("zh_CN"), I18n("en_US")
    for key, texts in STRINGS.items():
        assert "zh_CN" in texts, f"{key} missing zh_CN"
        assert zh(key) == texts["zh_CN"]
        assert en(key) == texts.get("en_US", texts["zh_CN"])
    assert I18n("fr_FR").language == "zh_CN"
    assert I18n("de").language == "zh_CN"
    assert zh("definitely_not_a_key") == "definitely_not_a_key"
    # the JAX UI's keys, with "TPU" dropped from the title only
    assert set(STRINGS) == set(jwebui.STRINGS)
    for key, texts in STRINGS.items():
        want = {k: v.replace(" TPU", "") for k, v in jwebui.STRINGS[key].items()}
        assert texts == (want if key == "title" else jwebui.STRINGS[key]), key
    assert "TPU" not in en("title") and "TPU" not in zh("title")


def test_config_roundtrip_edit_preserves_comments(tmp_path):
    dst = str(tmp_path / "train.yaml")
    text = edit_config_file(BASE, dst, UPDATES)
    cfg = load_config(dst)
    assert cfg.train.learning_rate == 1.5e-4
    assert cfg.train.batch_size == 4
    assert cfg.train.model == "mymodel"
    assert cfg.train.pretrain == "vits_pretrain/sovits5.0.pretrain.pth"
    assert cfg.train.nan_guard is False
    assert cfg.log.info_interval == 50 and cfg.log.keep_ckpts == 3
    orig = open(BASE).read()
    assert cfg.data.hop_length == 320
    assert cfg.mpd.periods == [2, 3, 5, 7, 11]
    comments = [ln for ln in orig.split("\n") if ln.lstrip().startswith("#")]
    assert comments == [ln for ln in text.split("\n") if ln.lstrip().startswith("#")]
    with pytest.raises(KeyError):
        edit_config_file(BASE, dst, {"train": {"nonexistent_key": 1}})


def test_config_edit_is_byte_equal_to_jax(tmp_path):
    ours = edit_config_file(BASE, str(tmp_path / "a.yaml"), UPDATES)
    theirs = j_edit_config_file(BASE, str(tmp_path / "b.yaml"), UPDATES)
    assert ours == theirs
    assert (tmp_path / "a.yaml").read_bytes() == (tmp_path / "b.yaml").read_bytes()
    for missing in ({"train": {"nope": 1}}, {"nosection": {"x": 1}}):
        with pytest.raises(KeyError) as ours_err:
            edit_config_file(BASE, str(tmp_path / "a.yaml"), missing)
        with pytest.raises(KeyError) as theirs_err:
            j_edit_config_file(BASE, str(tmp_path / "b.yaml"), missing)
        assert str(ours_err.value) == str(theirs_err.value)


def test_json_config_edit_rewrites_only_the_named_keys(tmp_path):
    src = tmp_path / "base.json"
    src.write_text(json.dumps(BASE_MODEL_CONFIG, indent=2))
    text = edit_config_file(str(src), str(tmp_path / "train.json"), UPDATES)
    got, before = json.loads(text), json.loads(src.read_text())
    assert list(got) == list(before)
    for section, kv in before.items():
        assert list(got[section]) == list(kv), section
        for k, v in kv.items():
            assert got[section][k] == UPDATES.get(section, {}).get(k, v), (section, k)
    assert load_config(str(tmp_path / "train.json")).train.model == "mymodel"
    with pytest.raises(KeyError, match="nonexistent_key"):
        edit_config_file(str(src), str(tmp_path / "x.json"), {"train": {"nonexistent_key": 1}})
    assert not (tmp_path / "x.json").exists()


def test_dump_config_round_trips():
    import yaml

    cfg = load_config(BASE)
    text = dump_config(cfg)
    assert "raw" not in yaml.safe_load(text)
    assert yaml.safe_load(text) == yaml.safe_load(cfg.raw)


def test_create_train_config_from_form(tmp_path):
    dst = str(tmp_path / "train.yaml")
    form = dict(model_name="run1", learning_rate="2e-4", batch_size="16", info_interval="10",
                eval_interval="2", save_interval="1", keep_ckpts="2", use_pretrain="1",
                pretrain_path="vits_pretrain/x.pth")
    create_train_config(BASE, dst, form)
    cfg = load_config(dst)
    assert cfg.train.model == "run1"
    assert cfg.train.learning_rate == 2e-4
    assert cfg.train.batch_size == 16
    assert cfg.log.eval_interval == 2
    assert cfg.train.pretrain == "vits_pretrain/x.pth"
    jdst = str(tmp_path / "jax.yaml")
    jwebui.create_train_config(BASE, jdst, form)
    assert open(dst, "rb").read() == open(jdst, "rb").read()
    form2 = dict(form)
    form2.pop("use_pretrain")
    create_train_config(BASE, dst, form2)
    assert load_config(dst).train.pretrain == ""


def _serve(device="cpu"):
    server = webui.make_server("127.0.0.1", 0, device)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def test_webui_http_surface():
    server, url = _serve()
    try:
        page = urllib.request.urlopen(f"{url}/?lang=en_US", timeout=10).read().decode()
        assert "Preprocessing-Training" in page and "svc_out.wav" in page
        assert "whisper-vits-svc console" in page and "TPU" not in page
        zh_page = urllib.request.urlopen(f"{url}/?lang=zh_CN", timeout=10).read().decode()
        assert "预处理-训练" in zh_page
        assert urllib.request.urlopen(f"{url}/log", timeout=10).read().decode()
    finally:
        server.shutdown()
        server.server_close()


def test_webui_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        webui.make_server("127.0.0.1", 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        webui.main(["--port", "0"])


def test_export_job_runs_the_port_cli(tmp_path, monkeypatch):
    """POST /export on a CPU server runs cli.export's main with --device cpu
    in a job thread; /log reads the job done and the file is written."""
    from whisper_vits_svc_tpu.utils.testing import micro_hp
    from whisper_vits_svc_tpu_torch.infer import pipeline
    from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

    monkeypatch.chdir(tmp_path)
    model = pipeline.build_infer_model(config_from_dict(micro_hp()), device="cpu", seed=1)
    torch.save({"model_g": model.state_dict()}, tmp_path / "g.pth")
    server, url = _serve()
    try:
        body = urllib.parse.urlencode({"checkpoint": "g.pth", "lang": "en_US"}).encode()
        urllib.request.urlopen(urllib.request.Request(f"{url}/export", data=body), timeout=10)
        log = ""
        for _ in range(200):
            log = urllib.request.urlopen(f"{url}/log", timeout=10).read().decode()
            if "[running]" not in log:
                break
            time.sleep(0.05)
        assert "== export [done] ==" in log and "Start exporting model" in log, log
        sd = torch.load(tmp_path / "sovits5.0_export.pth", weights_only=True)["model_g"]
        assert sd.keys() == model.state_dict().keys()
        # a failing job reads failed
        body = urllib.parse.urlencode({"checkpoint": "missing.pth"}).encode()
        urllib.request.urlopen(urllib.request.Request(f"{url}/export", data=body), timeout=10)
        for _ in range(200):
            log = urllib.request.urlopen(f"{url}/log", timeout=10).read().decode()
            if "[running]" not in log:
                break
            time.sleep(0.05)
        assert "== export [failed] ==" in log and "ERROR" in log, log
    finally:
        server.shutdown()
        server.server_close()
