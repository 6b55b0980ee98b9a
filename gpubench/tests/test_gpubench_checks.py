"""Whole runs of each cell on the CPU at a small size, past the harness's
look for a card: a sound run comes out correct, and a run with a fault
planted under the timed path (faults.py) comes out not correct, each
compared number printed beside its limit. The faults: a token shifted
where it is produced, a decode step that keeps its rows' lengths, half
the batch left out of the loss, a step that leaves the params as they
were."""

import pytest

from gpubench import run

# widths cut to 256, weights drawn 4 times wider (0.02 x sqrt(4096 / 256))
# so that activations and logits have the full model's scale
MIX_CFG = {"hidden_size": 256, "intermediate_size": 512,
           "init": {"std": 0.08, "embed_std": 1.0},
           "num_hidden_layers": 2, "num_attention_heads": 8,
           "num_key_value_heads": 4, "vocab_size": 512,
           "port": {"size": "tiny", "n_layers": 2, "vocab_size": 512,
                    "max_seq_len": 512},
           "engine": {"max_slots": 4, "max_len": 512, "min_bucket": 64}}
DOCS = {"prompt_tokens": {"median": 100, "sigma": 0.4, "min": 70,
                          "max": 300},
        "output_tokens": {"median": 24, "sigma": 0.3, "min": 17, "max": 40},
        "warmup_s": 1, "sample_requests": 4}
CHAT = {"prompt_tokens": {"median": 60, "sigma": 0.8, "min": 20, "max": 200},
        "output_tokens": {"median": 24, "sigma": 0.3, "min": 17, "max": 40},
        "warmup_s": 2, "rate_per_s": 1.0, "tail_s": 20, "wait_s": 40,
        "sample_requests": 4}
GPT_CFG = {"n_embd": 768, "n_layer": 2, "n_head": 12, "vocab_size": 512,
           "n_positions": 64,
           "port": {"size": "124m", "n_layers": 2, "vocab_size": 512,
                    "max_seq_len": 64}}
TRAIN = {"batch": 4, "seq": 64, "reference_rows": 2}

CELLS = {"mixtral-docs": (MIX_CFG, DOCS, 3),
         "mixtral-chat": (MIX_CFG, CHAT, 4),
         "gpt2xl-train": (GPT_CFG, TRAIN, 3)}


def one(cell, *extra):
    cfg, mix, seconds = CELLS[cell]
    return run.main(["--workload", cell, "--seed", "2147483801",
                     "--seconds", str(seconds), *extra], device="cpu",
                    cfg_update=cfg, mix_update=mix)


@pytest.mark.parametrize("cell, fault", [
    ("mixtral-docs", None), ("mixtral-docs", "token_altered"),
    ("mixtral-docs", "state_unchanged"), ("mixtral-chat", None),
    ("mixtral-chat", "token_altered"), ("gpt2xl-train", None),
    ("gpt2xl-train", "half_batch"), ("gpt2xl-train", "state_unchanged")])
def test_run_is_correct_unless_broken(cell, fault, capsys):
    line = one(cell, *(("--fault", fault) if fault else ()))
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(line["checks"]):] == [
        f"check {k}: {v['value']!r} (limit {v['limit']!r})"
        for k, v in line["checks"].items()]
    assert line["attempted"] > 0 and line["device"]["count"] == 1


@pytest.mark.parametrize("rec, kind", [
    ({"done": True, "ids": [5, 6, 7], "max_tokens": 3}, "finished"),
    # cut when the wait ran out, still serving: late, judged by its tokens
    ({"done": False, "ids": [5, 6], "max_tokens": 3}, "late"),
    ({"done": False, "ids": [], "max_tokens": 3}, "failed"),
    ({"done": False, "ids": [5], "max_tokens": 3,
      "error": "stream ended before [DONE]"}, "failed"),
    ({"done": True, "ids": [5, 6], "max_tokens": 3}, "failed")])
def test_a_stream_cut_while_serving_is_late_not_failed(rec, kind):
    from gpubench.drivers import serve_http

    assert serve_http.outcome(rec) == kind
