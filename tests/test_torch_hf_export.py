"""The port's HF export (``models/hf_export.py``) on the CPU.

HF -> port -> HF round trips: a ``transformers`` model built from an
in-code config (random weights from a seed, nothing downloaded) is saved,
converted and loaded by the port, exported again, and reloaded by
``AutoModelForCausalLM.from_pretrained``; its logits must equal the
original model's within 1e-5 (JAX's ``tests/test_hf_export.py`` bound: the
same fp32 weights, so only a layout error could move them). The export CLI
restores a DCP checkpoint of a CPU training run and writes a checkpoint
that ``transformers`` loads, with logits within 1e-4 of the port's own
fp32 forward on the trained params. For the same params the tensors and
``config.json`` equal those the JAX ``export_hf_checkpoint`` writes."""
import json

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

import jax.numpy as jnp  # noqa: E402

from distributed_training_guide_tpu.models.hf_export import (  # noqa: E402
    export_hf_checkpoint as jax_export)
from distributed_training_guide_tpu.models.registry import (  # noqa: E402
    get_model as jax_get_model)
from distributed_training_guide_tpu_torch.models import (  # noqa: E402
    from_jax, get_model, hf_export)
from distributed_training_guide_tpu_torch.models.hf_convert import (  # noqa: E402
    convert_hf_checkpoint, load_pretrained)

from test_torch_hf_convert import _bundle, _saved  # noqa: E402

ROUNDTRIP_TOL = 1e-5
LOGIT_TOL = 1e-4
ROUNDTRIP = ["llama", "llama3-tied", "mistral", "qwen2", "qwen3", "gemma",
             "gemma2", "olmo2", "mixtral", "qwen2_moe", "qwen3_moe", "gpt2",
             "gpt_neox"]


def _loaded(tmp_path, arch):
    model, seq = _saved(tmp_path, arch)
    bundle = _bundle(tmp_path)
    convert_hf_checkpoint(tmp_path / "hf", tmp_path / "conv", bundle=bundle)
    return model, seq, bundle, load_pretrained(bundle, None,
                                               tmp_path / "conv",
                                               device="cpu")


@pytest.mark.parametrize("arch", ROUNDTRIP)
def test_hf_port_hf_round_trip(tmp_path, arch):
    model, seq, bundle, params = _loaded(tmp_path, arch)
    hf_export.export_hf_checkpoint(bundle, params, tmp_path / "out")
    back = transformers.AutoModelForCausalLM.from_pretrained(
        tmp_path / "out").eval()
    assert type(back) is type(model)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128,
                                                             (2, seq)))
    with torch.no_grad():
        want = model(ids).logits.float().numpy()
        got = back(ids).logits.float().numpy()
    np.testing.assert_allclose(got, want, rtol=ROUNDTRIP_TOL,
                               atol=ROUNDTRIP_TOL)


@pytest.mark.parametrize("arch", ["llama", "llama3-tied", "gemma2",
                                  "mixtral", "qwen2_moe", "qwen3_moe", "gpt2",
                                  "gpt_neox"])
def test_export_equals_the_jax_exporter(tmp_path, arch):
    """Same params in both packages (carried across as numpy): the same
    tensor names, bytes and config."""
    _, _, bundle, params = _loaded(tmp_path, arch)
    hf_export.export_hf_checkpoint(bundle, params, tmp_path / "port")
    jbundle = jax_get_model(f"hf:{tmp_path / 'hf'}", dtype=jnp.float32)

    def to_jax(tree):
        if isinstance(tree, dict):
            return {k: to_jax(v) for k, v in tree.items()}
        return jnp.asarray(tree)
    jparams = to_jax(from_jax.params_to_numpy(params))
    jax_export(jbundle, jparams, tmp_path / "jax")
    ours = safetensors_numpy.load_file(str(tmp_path / "port" /
                                           "model.safetensors"))
    theirs = safetensors_numpy.load_file(str(tmp_path / "jax" /
                                             "model.safetensors"))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))


def test_export_cli_from_a_checkpoint_of_a_cpu_run(tmp_path):
    from distributed_training_guide_tpu_torch.train import cli

    args = cli.get_parser().parse_args(
        ["-m", "llama-debug", "-d", "synthetic:20000", "-s", "64", "-b", "2",
         "--max-steps", "2", "--log-freq", "1", "--device", "cpu",
         "-e", "run", "--save-dir", str(tmp_path), "--ckpt-freq", "2",
         "--precision-policy", "bf16-master"])
    out = cli.run_training(args)
    hf_export.main(["-m", "llama-debug", "-e", str(tmp_path / "run"), "-o",
                    str(tmp_path / "hf"), "--precision-policy",
                    "bf16-master", "--device", "cpu"])
    back = transformers.AutoModelForCausalLM.from_pretrained(
        tmp_path / "hf").eval()
    bundle = get_model("llama-debug", dtype=torch.float32)
    params = out["state"].params
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512,
                                                             (2, 64)))
    with torch.no_grad():
        theirs = back(ids).logits.float()
        ours = bundle.apply(bundle.config, params, ids)
    err = float((ours - theirs).abs().max())
    assert err <= LOGIT_TOL * float(theirs.abs().max())


def test_unported_family_export_names_its_item():
    """Every family exports; a bundle of no family is refused naming the
    families there are."""
    bundle = get_model("llama-debug")
    fake = type(bundle)(bundle.name, bundle.config, bundle.init,
                        bundle.apply, family="bert")
    with pytest.raises(KeyError, match="'bert'.*gpt2"):
        hf_export.export_hf_checkpoint(fake, {}, "/nonexistent")

