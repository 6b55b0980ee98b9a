"""The engine-phase readers of ``mixtral-chat``: a traced chat run on the
CPU at the harness's small size reads each of them, and they agree with
the counters they split; over a program without those counters (an older
engine's /v1/stats) each reads nothing and raises nothing."""

import pytest

from gpubench import run
from gpubench.common import load_module, metric_file
from gpubench.tests.test_gpubench_checks import CHAT, MIX_CFG

NEW = ("queue_wait_ms.chat", "prefill_ms.chat", "decode_launch_ms.chat",
       "decode_sync_ms.chat", "launch_cpu_share.chat", "decode_rows.chat")


def test_a_traced_chat_run_reads_every_engine_phase(capsys):
    line = run.main(["--workload", "mixtral-chat", "--seed", "2147483801",
                     "--seconds", "4", "--trace", "1"], device="cpu",
                    cfg_update=MIX_CFG,
                    mix_update=dict(CHAT, trace_start_s=2,
                                    trace_length_s=1))
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(m), sorted(m)
    assert line["correct"], line["checks"]
    step = m["decode_step_ms.chat"]
    assert 0.9 * step <= m["decode_launch_ms.chat"] + \
        m["decode_sync_ms.chat"] <= step * (1 + 1e-9)
    assert 0 < m["launch_cpu_share.chat"] <= 100.5
    assert 1 <= m["decode_rows.chat"] <= MIX_CFG["engine"]["max_slots"]
    assert m["queue_wait_ms.chat"] >= 0 and m["prefill_ms.chat"] > 0
    assert line["metrics"]["decode_rows.chat"]["unit"] == "rows"


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_counters_reads_nothing(name):
    stats = {"decode_steps": 10, "decode_seconds": 1.0}
    layer = {"before": {"stats": dict(stats, decode_steps=0,
                                      decode_seconds=0.0), "metrics": {}},
             "after": {"stats": stats, "metrics": {}}}
    reader = load_module(metric_file(name), "m_" + name)
    assert reader.read(layer) is None
    assert reader.read({"before": None, "after": None}) is None


def test_profile_chat_runs_the_hook_in_the_chat_setting(capsys):
    """``profile_chat.py`` turns the replica's profile routes on and gets
    the hook's reduction and three counter windows back over HTTP."""
    from gpubench import profile_chat, serving

    make_config = serving.llm_config
    out = profile_chat.main(["--seed", "2147483802", "--seconds", "5"],
                            device="cpu", cfg_update=MIX_CFG,
                            mix_update=dict(CHAT, trace_start_s=2,
                                            trace_length_s=1))
    assert serving.llm_config is make_config
    assert out["errors"] == {} and out["correct"], out
    hook = out["hook"]
    assert hook["kernels"] > 0 and not hook["capped"]
    assert out["idle_by_phase_sum_s"] == pytest.approx(hook["idle_s"],
                                                       rel=1e-9)
    assert set(out["windows"]) == {"off_before", "on", "off_after"}
    assert out["warm"]["kernels"] > 0
