"""The WebUI (JAX whisper_vits_svc_tpu/cli/webui.py): a browser front end
for preprocessing, training, export and inference.

The reference Gradio app's surface (app.py:13-146: one-key preprocess +
train, the training parameters written back to configs/train.yaml, model
export, inference with a pitch shift, zh/en i18n app.py:314-421) on the
standard library's http.server, with no dependency. Each job runs the
port's CLI `main` in a daemon thread, its output in a log buffer the page
polls.

    python -m whisper_vits_svc_tpu_torch.cli.webui [--port 7860] [--lang en_US]
        [--device cuda|cpu]

Every job runs on --device (the card by default; without CUDA the UI
refuses to start unless given --device cpu). A `.json` config is edited as
JSON (utils/config.py::edit_config_file): the card's machine has no PyYAML.
"""

from __future__ import annotations

import html
import io
import locale as _locale
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_JOBS: dict[str, dict] = {}


# ---------------------------------------------------------------------------
# i18n — the reference resolves UI strings through an I18nAuto chain keyed on
# zh_CN source strings (app.py:423-440). Here each UI string is a symbolic
# key with per-language texts; unknown languages fall back along SUPER links
# (en_US -> zh_CN -> END), matching the reference's resolution order.
# ---------------------------------------------------------------------------

LANGUAGES = {"zh_CN": {"super": None}, "en_US": {"super": "zh_CN"}}

STRINGS = {
    "title":            {"zh_CN": "whisper-vits-svc 控制台", "en_US": "whisper-vits-svc console"},
    "tab_train":        {"zh_CN": "预处理-训练", "en_US": "Preprocessing-Training"},
    "dataset_dir":      {"zh_CN": "数据集文件夹", "en_US": "Dataset folder"},
    "config_file":      {"zh_CN": "配置文件", "en_US": "Config file"},
    "model_name":       {"zh_CN": "模型名称", "en_US": "Model name"},
    "learning_rate":    {"zh_CN": "学习率", "en_US": "Learning rate"},
    "batch_size":       {"zh_CN": "批大小", "en_US": "Batch size"},
    "info_interval":    {"zh_CN": "训练日志记录间隔（step）", "en_US": "Training log recording interval (step)"},
    "eval_interval":    {"zh_CN": "验证集验证间隔（epoch）", "en_US": "Validation set validation interval (epoch)"},
    "save_interval":    {"zh_CN": "检查点保存间隔（epoch）", "en_US": "Checkpoint save interval (epoch)"},
    "keep_ckpts":       {"zh_CN": "保留最新的检查点文件(0保存全部)", "en_US": "Keep the latest checkpoint file (0 save all)"},
    "use_pretrain":     {"zh_CN": "是否添加底模", "en_US": "Whether to add the base model"},
    "pretrain_path":    {"zh_CN": "底模路径", "en_US": "Base model path"},
    "max_steps":        {"zh_CN": "最大步数（留空=完整训练）", "en_US": "Max steps (blank = full training)"},
    "btn_preprocess":   {"zh_CN": "预处理", "en_US": "Preprocess"},
    "btn_train":        {"zh_CN": "训练", "en_US": "Train"},
    "btn_onekey":       {"zh_CN": "一键训练", "en_US": "One-click training"},
    "resume_from":      {"zh_CN": "从检查点恢复训练进度", "en_US": "Restore training progress from checkpoint"},
    "btn_resume":       {"zh_CN": "恢复训练", "en_US": "Resume training"},
    "tab_export":       {"zh_CN": "导出模型", "en_US": "Export model"},
    "checkpoint":       {"zh_CN": "检查点", "en_US": "Checkpoint"},
    "btn_export":       {"zh_CN": "导出推理模型", "en_US": "Export inference model"},
    "tab_infer":        {"zh_CN": "推理", "en_US": "Inference"},
    "model_file":       {"zh_CN": "模型文件", "en_US": "Model file"},
    "input_wav":        {"zh_CN": "选择待转换音频", "en_US": "Select audio to be converted"},
    "speaker_file":     {"zh_CN": "选择音色文件", "en_US": "Select timbre file"},
    "pitch_shift":      {"zh_CN": "变调（半音）", "en_US": "Pitch shift (semitones)"},
    "btn_convert":      {"zh_CN": "开始转换", "en_US": "Start conversion"},
    "output_hint":      {"zh_CN": "（输出：svc_out.wav）", "en_US": "(output: svc_out.wav)"},
    "jobs":             {"zh_CN": "任务日志", "en_US": "Job log"},
    "no_jobs":          {"zh_CN": "（还没有任务）", "en_US": "(no jobs yet)"},
    "start_preprocess": {"zh_CN": "开始预处理", "en_US": "Start preprocessing"},
    "start_train":      {"zh_CN": "开始训练", "en_US": "Start training"},
    "start_export":     {"zh_CN": "开始导出模型", "en_US": "Start exporting model"},
    "export_done":      {"zh_CN": "导出模型成功", "en_US": "Model exported successfully"},
    "start_infer":      {"zh_CN": "开始推理", "en_US": "Start inference"},
    "infer_done":       {"zh_CN": "推理成功", "en_US": "Inference successful"},
    "error":            {"zh_CN": "出现错误：", "en_US": "An error occurred:"},
    "language":         {"zh_CN": "语言", "en_US": "Language"},
}


class I18n:
    """Key -> localized string with SUPER-chain fallback (app.py:423-440)."""

    def __init__(self, language: str | None = None):
        lang = (language or os.environ.get("SVC_WEBUI_LANG")
                or (_locale.getlocale()[0] or ""))
        self.language = lang if lang in LANGUAGES else "zh_CN"

    def __call__(self, key: str) -> str:
        texts = STRINGS.get(key)
        if texts is None:
            return key
        lang = self.language
        while lang is not None:
            if lang in texts:
                return texts[lang]
            lang = LANGUAGES[lang]["super"]
        return key


def _run_job(name: str, fn, *args, announce: str = "", **kw):
    buf = io.StringIO()
    if announce:
        buf.write(announce + "\n")
    _JOBS[name] = {"status": "running", "log": buf}

    def target():
        import contextlib

        try:
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
                fn(*args, **kw)
            _JOBS[name]["status"] = "done"
        except (Exception, SystemExit) as e:  # surface the failure (argparse's too)
            buf.write(f"\nERROR: {e!r}\n")
            _JOBS[name]["status"] = "failed"

    threading.Thread(target=target, daemon=True).start()


def create_train_config(base_config: str, out_path: str, form: dict) -> str:
    """Round-trip edit of the training config from WebUI form fields
    (reference app.py:169-180, a ruamel round trip)."""
    from ..utils.config import edit_config_file

    updates = {"train": {}, "log": {}}
    if form.get("model_name"):
        updates["train"]["model"] = form["model_name"]
    for key, cast in [("learning_rate", float), ("batch_size", int)]:
        if form.get(key):
            updates["train"][key] = cast(form[key])
    for key in ["info_interval", "eval_interval", "save_interval", "keep_ckpts"]:
        if form.get(key):
            updates["log"][key] = int(form[key])
    updates["train"]["pretrain"] = (
        form.get("pretrain_path", "vits_pretrain/sovits5.0.pretrain.pth")
        if form.get("use_pretrain") else ""
    )
    return edit_config_file(base_config, out_path, updates)


def _page(i18n: I18n, log_text: str) -> str:
    esc = html.escape
    t = i18n
    other = "en_US" if i18n.language == "zh_CN" else "zh_CN"
    return f"""<!doctype html><html><head><title>{esc(t('title'))}</title>
<style>body{{font-family:sans-serif;max-width:900px;margin:2em auto}}
fieldset{{margin-bottom:1.5em}} pre{{background:#f4f4f4;padding:1em;max-height:300px;overflow:auto}}
input[type=text]{{width:22em}} label{{display:inline-block;min-width:22em}}</style></head><body>
<h1>{esc(t('title'))}</h1>
<p><a href="/?lang={other}">{esc(t('language'))}: {other}</a></p>
<fieldset><legend>{esc(t('tab_train'))}</legend>
<form method="post" action="/train">
  <input type="hidden" name="lang" value="{i18n.language}">
  <label>{esc(t('dataset_dir'))}</label><input type="text" name="dataset" value="dataset_raw"><br><br>
  <label>{esc(t('config_file'))}</label><input type="text" name="config" value="configs/base.yaml"><br><br>
  <label>{esc(t('model_name'))}</label><input type="text" name="model_name" value="sovits5.0"><br><br>
  <label>{esc(t('learning_rate'))}</label><input type="text" name="learning_rate" value="5e-5"><br><br>
  <label>{esc(t('batch_size'))}</label><input type="text" name="batch_size" value="8"><br><br>
  <label>{esc(t('info_interval'))}</label><input type="text" name="info_interval" value="100"><br><br>
  <label>{esc(t('eval_interval'))}</label><input type="text" name="eval_interval" value="1"><br><br>
  <label>{esc(t('save_interval'))}</label><input type="text" name="save_interval" value="5"><br><br>
  <label>{esc(t('keep_ckpts'))}</label><input type="text" name="keep_ckpts" value="0"><br><br>
  <label>{esc(t('use_pretrain'))}</label><input type="checkbox" name="use_pretrain" value="1">
  <input type="text" name="pretrain_path" value="vits_pretrain/sovits5.0.pretrain.pth"><br><br>
  <label>{esc(t('max_steps'))}</label><input type="text" name="max_steps" value=""><br><br>
  <label>{esc(t('resume_from'))}</label><input type="text" name="resume" value=""><br><br>
  <button name="action" value="preprocess">{esc(t('btn_preprocess'))}</button>
  <button name="action" value="train">{esc(t('btn_train'))}</button>
  <button name="action" value="onekey">{esc(t('btn_onekey'))}</button>
  <button name="action" value="resume">{esc(t('btn_resume'))}</button>
</form></fieldset>
<fieldset><legend>{esc(t('tab_export'))}</legend>
<form method="post" action="/export">
  <input type="hidden" name="lang" value="{i18n.language}">
  <label>{esc(t('checkpoint'))}</label><input type="text" name="checkpoint" value="chkpt/sovits5.0/sovits5.0_0005.pth">
  <button>{esc(t('btn_export'))}</button>
</form></fieldset>
<fieldset><legend>{esc(t('tab_infer'))}</legend>
<form method="post" action="/infer">
  <input type="hidden" name="lang" value="{i18n.language}">
  <label>{esc(t('config_file'))}</label><input type="text" name="config" value="configs/base.yaml"><br><br>
  <label>{esc(t('model_file'))}</label><input type="text" name="model" value="sovits5.0_export.pth"><br><br>
  <label>{esc(t('input_wav'))}</label><input type="text" name="wave" value="test.wav"><br><br>
  <label>{esc(t('speaker_file'))}</label><input type="text" name="spk" value="data_svc/singer/speaker0.spk.npy"><br><br>
  <label>{esc(t('pitch_shift'))}</label><input type="text" name="shift" value="0"><br><br>
  <button>{esc(t('btn_convert'))}</button> {esc(t('output_hint'))}
</form></fieldset>
<fieldset><legend>{esc(t('jobs'))}</legend><pre id="log">{esc(log_text)}</pre></fieldset>
<script>setInterval(async()=>{{const r=await fetch('/log');document.getElementById('log').textContent=await r.text();}},2000)</script>
</body></html>"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, body: str, code=200, ctype="text/html"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _log_text(self, i18n: I18n) -> str:
        parts = []
        for name, job in _JOBS.items():
            parts.append(f"== {name} [{job['status']}] ==")
            parts.append(job["log"].getvalue()[-4000:])
        return "\n".join(parts) or i18n("no_jobs")

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(url.query)
        i18n = I18n(q.get("lang", [None])[0])
        if url.path == "/log":
            self._send(self._log_text(i18n), ctype="text/plain")
        else:
            self._send(_page(i18n, self._log_text(i18n)))

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        form_qs = urllib.parse.parse_qs(self.rfile.read(length).decode())
        form = {k: v[0] for k, v in form_qs.items()}
        get = form.get
        i18n = I18n(get("lang"))
        on = ["--device", getattr(self.server, "device", "cuda")]

        if self.path == "/train":
            action = get("action")
            if action in ("preprocess", "onekey"):
                from .preprocessing import main as pre_main

                _run_job("preprocess", pre_main,
                         ["--dataset-raw", get("dataset", "dataset_raw"),
                          "-c", get("config", "configs/base.yaml"), *on],
                         announce=i18n("start_preprocess"))
            if action in ("train", "onekey", "resume"):
                from .trainer import main as train_main

                # round-trip edit base config -> configs/train.yaml (or
                # train.json) with the form's training parameters (reference
                # app.py:169-180)
                cfg = get("config", "configs/base.yaml")
                train_cfg = os.path.join(os.path.dirname(cfg) or ".",
                                         "train" + os.path.splitext(cfg)[1])
                create_train_config(cfg, train_cfg, form)
                argv = ["-c", train_cfg, "-n", get("model_name", "sovits5.0"), *on]
                if get("max_steps"):
                    argv += ["--max-steps", get("max_steps")]
                if action == "resume" and get("resume"):
                    argv += ["-p", get("resume")]
                _run_job("train", train_main, argv, announce=i18n("start_train"))
        elif self.path == "/export":
            from .export import main as export_main

            _run_job("export", export_main, ["--checkpoint", get("checkpoint", ""), *on],
                     announce=i18n("start_export"))
        elif self.path == "/infer":
            from .inference import main as infer_main

            _run_job("infer", infer_main, [
                "--config", get("config", "configs/base.yaml"),
                "--model", get("model", ""),
                "--wave", get("wave", ""), "--spk", get("spk", ""),
                "--shift", get("shift", "0"), *on,
            ], announce=i18n("start_infer"))
        self.send_response(303)
        self.send_header("Location", f"/?lang={i18n.language}")
        self.end_headers()


def make_server(host: str = "127.0.0.1", port: int = 7860,
                device: str = "cuda") -> ThreadingHTTPServer:
    """The UI's server (port 0 picks a free one); its jobs run on `device`,
    which must be usable (resolve_device raises without CUDA)."""
    from ..utils.device import resolve_device

    server = ThreadingHTTPServer((host, port), _Handler)
    server.device = resolve_device(device).type
    return server


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="app")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--lang", default=None, choices=list(LANGUAGES))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.lang:
        os.environ["SVC_WEBUI_LANG"] = args.lang
    server = make_server(args.host, args.port, args.device)
    print(f"WebUI at http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
