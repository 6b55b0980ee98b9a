"""The harness finds a configuration, a traffic mix, a per-layer metric
and a kernel of an operation by name, as files added beside the others,
with no file edited; a metric of a new cell finds the reader its quantity
shares across cells (``idle_share.py`` for ``idle_share.<cell>``)."""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)


def test_new_files_are_found(tmp_path):
    shutil.copytree(PKG, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    g = tmp_path / "gpubench"
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in g.rglob("*") if x.is_file())}
    cfg = json.load(open(g / "configs" / "mixtral-8x7b-l16.json"))
    cfg["name"] = "mixtral-8x7b-l8"
    cfg["num_hidden_layers"] = 8
    (g / "configs" / "mixtral-8x7b-l8.json").write_text(json.dumps(cfg))
    mix = json.load(open(g / "traffic" / "chat.json"))
    mix["rate_per_s"] = 1.0
    (g / "traffic" / "chat-slow.json").write_text(json.dumps(mix))
    (g / "metrics" / "prompt_tokens.slow.py").write_text(
        "def read(layer):\n    return float(sum(len(r['prompt']) for r in "
        "layer['records']))\n")
    (g / "ops" / "kernels" / "ragged_decode" / "my_new_kernel.txt") \
        .write_text("a new kernel of the operation\n")
    (g / "limits" / "mixtral-slow.json").write_text(
        (g / "limits" / "mixtral-chat.json").read_text())
    bench["configs"].append({"name": "mixtral-8x7b-l8", "source": "x",
                             "file": "gpubench/configs/mixtral-8x7b-l8.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "mixtral-slow",
                               "config": "mixtral-8x7b-l8",
                               "traffic": "chat-slow", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "prompt_tokens.slow", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine scheduler",
                               "moves": "ttft_p90_ms",
                               "workloads": ["mixtral-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, os
from gpubench import check, ops, weights
from gpubench.common import (ROOT, benchmark, load_json, load_module,
                             metric_file, named_file)
b = benchmark()
cell = next(w for w in b["workloads"] if w["name"] == "mixtral-slow")
c = next(c for c in b["configs"] if c["name"] == cell["config"])
cfg = load_json(os.path.join(ROOT, c["file"]))
mix = load_json(named_file("traffic", cell["traffic"]))
m = load_module(named_file("metrics", "prompt_tokens.slow", ".py"), "m")
shared = load_module(metric_file("idle_share.slow"), "s")
print(json.dumps({"L": weights.dims(cfg)["L"], "rate": mix["rate_per_s"],
                  "read": m.read({"records": [{"prompt": [1, 2, 3]}]}),
                  "shared": shared.read({"trace": {
                      "kernels": 1, "busy_s": 3.0, "window_s": 4.0}}),
                  "kernels": ops.kernel_names("ragged_decode"),
                  "limits": sorted(check.limits("mixtral-slow"))}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"L": 8, "rate": 1.0, "read": 3.0, "shared": 25.0,
                   "kernels": ["my_new_kernel", "ragged_merge_kernel",
                               "ragged_split_kernel"],
                   "limits": ["gap_mean"]}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
