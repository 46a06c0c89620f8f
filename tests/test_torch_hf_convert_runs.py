"""The HF converter's two long runs, on the CPU (split from
``tests/test_torch_hf_convert.py``, whose test count puts it early in
pytest-xdist's loadfile queue: these two take most of its time, and a
file of few tests runs late, after the JAX package's
``tests/test_pipeline.py``, whose start bounds the tier-1 run).

The converter's streaming memory bound over a ~190 MB llama (peak
anonymous RSS in a subprocess), and the sharded load on 4 gloo ranks
(``tests/torch_dist_worker.py --scenario sharded_load``)."""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

from distributed_training_guide_tpu_torch.models.hf_convert import (  # noqa: E402
    convert_hf_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_RSS_SCRIPT = """
import gc, json, os, sys, threading, time

import torch
import transformers

sys.path.insert(0, os.environ["REPO_ROOT"])
from distributed_training_guide_tpu_torch.models import get_model
from distributed_training_guide_tpu_torch.models.hf_convert import (
    convert_hf_checkpoint)

OUT = os.environ["RSS_TMP"]

# ~190 MB of fp32 weights; largest single tensor ~12.6 MB (embed/lm_head)
kw = dict(vocab_size=4096, hidden_size=768, intermediate_size=2048,
          num_layers=6, num_heads=8, num_kv_heads=4,
          max_position_embeddings=256)
hf_cfg = transformers.LlamaConfig(
    num_hidden_layers=kw["num_layers"], num_attention_heads=kw["num_heads"],
    num_key_value_heads=kw["num_kv_heads"], tie_word_embeddings=False,
    **{k: kw[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                          "max_position_embeddings")})
torch.manual_seed(0)
model = transformers.LlamaForCausalLM(hf_cfg)
model.save_pretrained(os.path.join(OUT, "hf"), safe_serialization=True)
total_bytes = sum(p.numel() * 4 for p in model.parameters())
del model
gc.collect()


def rss_anon() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon"):
                return int(line.split()[1]) * 1024
    return -1


baseline = rss_anon()
peak = [baseline]
stop = threading.Event()


def sampler():
    while not stop.is_set():
        peak[0] = max(peak[0], rss_anon())
        time.sleep(0.005)


t = threading.Thread(target=sampler, daemon=True)
t.start()
bundle = get_model("llama-debug", **kw)
convert_hf_checkpoint(os.path.join(OUT, "hf"), os.path.join(OUT, "conv"),
                      bundle=bundle)
stop.set()
t.join()
print("RSS:" + json.dumps({"total_bytes": total_bytes, "baseline": baseline,
                           "peak_delta": peak[0] - baseline}))
"""


def test_conversion_streams_one_tensor_at_a_time(tmp_path):
    """``tests/test_405b_recipe.py``'s bound on the port's converter: over
    a ~190 MB model, peak anonymous RSS during the conversion grows by
    less than 60 MB (a few tensors), never the model (the output memmaps'
    dirty pages are file-backed)."""
    env = dict(os.environ, RSS_TMP=str(tmp_path), REPO_ROOT=ROOT)
    proc = subprocess.run([sys.executable, "-c", _RSS_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RSS:"))
    rss = json.loads(line[len("RSS:"):])
    assert rss["total_bytes"] > 150e6
    assert rss["baseline"] > 0
    assert rss["peak_delta"] < 60e6, (
        f"conversion peaked {rss['peak_delta'] / 1e6:.0f} MB anon over "
        f"baseline for a {rss['total_bytes'] / 1e6:.0f} MB model")


def test_sharded_load_on_four_gloo_ranks_equals_the_whole_loads_shards(
        tmp_path):
    """Each rank reads only its slices of the converted memmaps under
    fsdp 4, tp 4 and tp_fsdp 2 x 2, and of a converted Qwen3-MoE (4
    experts) under ep 2 x fsdp 2 (``tests/torch_dist_worker.py
    --scenario sharded_load``): every leaf equals the plan's shard of the
    whole load, the expert stacks hold 2 experts a rank, and a step from
    the sharded load gives the loss of a step from the whole params."""
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(
        tmp_path / "hf", safe_serialization=True)
    convert_hf_checkpoint(tmp_path / "hf", tmp_path / "conv", "llama-debug")
    moe_cfg = transformers.Qwen3MoeConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=False, decoder_sparse_step=1,
        mlp_only_layers=[], max_position_embeddings=256,
        tie_word_embeddings=False)
    transformers.Qwen3MoeForCausalLM(moe_cfg).save_pretrained(
        tmp_path / "hf_moe", safe_serialization=True)
    convert_hf_checkpoint(tmp_path / "hf_moe", tmp_path / "conv_moe",
                          f"hf:{tmp_path / 'hf_moe'}")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "distributed_training_guide_tpu_torch.launch."
         "local", "--nproc", "4", "--log-dir", str(tmp_path / "logs"), "--",
         sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         "--dir", str(tmp_path), "--scenario", "sharded_load"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    logs = "\n".join(p.read_text()[-3000:]
                     for p in sorted((tmp_path / "logs").glob("*.err")))
    assert out.returncode == 0, out.stderr[-3000:] + logs
    got = json.loads((tmp_path / "sharded_load.json").read_text())
    assert set(got) == {"fsdp", "tp", "tp_fsdp", "moe_ep_fsdp"}
    for plan, r in got.items():
        assert r["equal"] and r["step_equal"], (plan, r)
        assert r["sharded_leaves"] >= 8, (plan, r)
    for leaf, (whole, local) in got["moe_ep_fsdp"]["expert_shapes"].items():
        assert whole[1] == 4 and local[1] == 2, (leaf, whole, local)
