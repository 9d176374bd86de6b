"""The port's LoRA subsystem (audioldm_tpu_torch/lora, the adapter path of
models/nn.py and models/unet.py, the adapter bridges of ckpt/hf_bridge.py
and ``cli generate --lora``) against the JAX package, at tiny widths on the
CPU. Weights, adapters and inputs are made with numpy from a seed and handed
to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.config import UNetConfig
from audioldm_tpu.lora import adapter as jax_lora
from audioldm_tpu.models.nn import attention as jax_attention
from audioldm_tpu.models.unet import apply_unet, init_unet
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import from_jax_params, lora_from_jax, lora_to_numpy, read_safetensors, write_safetensors
from audioldm_tpu_torch.lora import (
    LoRAAdapters,
    compose_adapters,
    export_peft_state_dict,
    import_peft_state_dict,
    init_lora,
    iter_lora_paths,
    merge_lora,
    unmerge_lora,
)
from audioldm_tpu_torch.models.nn import Attention
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.pipeline import generate as port_gen
from test_torch_port_models import UNET, numpy_params
from test_torch_port_pipeline import SECONDS, _prompts, checkpoint, jax_modules  # noqa: F401 (fixtures)

ALL = ("to_q", "to_k", "to_v", "to_out")


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_adapters(params, targets, r, seed, scale=0.3):
    """A JAX adapter tree for ``params`` with NONZERO a and b from a numpy
    seed (with b = 0, as a fresh adapter has it, every gradient of a is 0)."""
    rng = np.random.default_rng(seed)
    tree = jax_lora.init_lora(jax.random.PRNGKey(0), params, JaxLoRAConfig(r=r, target_modules=targets))
    return jax.tree.map(lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


@pytest.fixture(scope="module")
def unet_pair():
    params = numpy_params(init_unet, UNetConfig(**UNET), 20)
    unet = UNet2DConditionModel(tcfg.UNetConfig(**UNET))
    unet.load_state_dict(from_jax_params(unet=params)["unet"], strict=True)
    return params, unet.eval().requires_grad_(False)


def test_attention_with_adapters_matches_jax():
    """One Attention with adapters on all four projections, 1e-5 (absolute
    and relative: fp32 sums in another order)."""
    c, heads, r = 16, 2, 3
    rng = np.random.default_rng(0)
    p = {n: {"kernel": (rng.standard_normal((c, c)) / 4).astype(np.float32)} for n in ALL}
    p["to_out"]["bias"] = _np(1, (c,))
    lora = {n: {"a": 0.3 * _np(2 + i, (c, r)), "b": 0.3 * _np(6 + i, (r, c))} for i, n in enumerate(ALL)}
    x = _np(10, (2, 12, c))
    ref = np.asarray(jax_attention(p, jnp.asarray(x), None, heads, lora=lora, lora_scale=0.5))

    attn = Attention(c, heads)
    attn.path = "blk.attn1"
    with torch.no_grad():
        for n in ALL:
            lin = attn.to_out[0] if n == "to_out" else getattr(attn, n)
            lin.weight.copy_(torch.from_numpy(p[n]["kernel"].T))
        attn.to_out[0].bias.copy_(torch.from_numpy(p["to_out"]["bias"]))
        adapters = lora_from_jax({"blk": {"attn1": lora}})
        out = attn(torch.from_numpy(x), None, adapters, 0.5).numpy()
        base = attn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert np.abs(out - base).max() > 1e-2  # the adapters are felt
    # an adapter keyed for another module is not applied
    with torch.no_grad():
        other = attn(torch.from_numpy(x), None, lora_from_jax({"blk": {"attn2": lora}}), 0.5).numpy()
    np.testing.assert_array_equal(other, base)


@pytest.mark.parametrize("targets", [("to_q", "to_v"), ALL])
def test_unet_with_adapters_matches_jax_output_and_grads(unet_pair, targets):
    """UNet with nonzero A and B against ``apply_unet(lora=, lora_scale=)``:
    output 1e-4, and the gradient of a scalar loss with respect to every A
    and B against ``jax.grad``, 1e-4 of the largest gradient entry."""
    params, unet = unet_pair
    jcfg = UNetConfig(**UNET)
    tree = jax_adapters(params, targets, 2, 30)
    adapters = lora_from_jax(tree)
    assert sorted(adapters.paths()) == sorted(p for p, _ in iter_lora_paths(unet, targets))
    x, emb, w = _np(31, (2, 8, 4, 4)), _np(32, (2, 8)), _np(33, (2, 8, 4, 4))
    t = np.array([700, 30])

    def loss_fn(lora):
        out = apply_unet(params, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb), lora=lora, lora_scale=1.5)
        return jnp.sum(out * w), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    out = unet(torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(t), torch.from_numpy(emb),
               lora=adapters, lora_scale=1.5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-4)
    (out * torch.from_numpy(w.transpose(0, 3, 1, 2))).sum().backward()
    assert all(p.grad is None for p in unet.parameters())
    grads = dict(_flat(lora_to_numpy(LoRAAdapters({p: (a.grad, b.grad) for p, a, b in adapters.items()}))))
    want = dict(_flat(ref_grads))
    assert grads.keys() == want.keys() and len(grads) == 2 * 8 * len(targets)
    top = max(np.abs(g).max() for g in want.values())
    for key in want:
        np.testing.assert_allclose(grads[key], want[key], atol=1e-4 * top, err_msg=key)
        assert np.abs(want[key]).max() > 0


def test_init_lora_follows_peft(unet_pair):
    params, unet = unet_pair
    cfg = tcfg.LoRAConfig(r=4)
    lora = init_lora(unet, cfg, torch.Generator().manual_seed(3))
    jax_paths = {".".join(p) for p, _ in jax_lora.iter_lora_paths(params, cfg.target_modules)}
    assert set(lora.paths()) == jax_paths and len(jax_paths) == 16
    for path, a, b in lora.items():
        lin = unet.get_submodule(path)
        assert a.shape == (lin.in_features, 4) and b.shape == (4, lin.out_features)
        assert a.dtype == b.dtype == torch.float32 and a.requires_grad and b.requires_grad
        assert not b.any()
    a_all = torch.cat([a.detach().reshape(-1) for _, a, _ in lora.items()])
    assert abs(a_all.std().item() - 0.25) < 0.03  # gaussian: N(0, 1/r^2)
    again = init_lora(unet, cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(lora.state_dict().values(), again.state_dict().values()))
    uni = init_lora(unet, tcfg.LoRAConfig(r=4, init_lora_weights=True, target_modules=("to_out",)), torch.Generator().manual_seed(3))
    for path, a, b in uni.items():
        assert path.endswith(".to_out") and a.abs().max() <= np.sqrt(6.0 / a.shape[0]) and not b.any()
    assert cfg.scale == 0.5 and tcfg.LoRAConfig().scale == JaxLoRAConfig().scale == 1.0


def test_merge_lora_matches_jax_and_the_unmerged_forward(unet_pair):
    params, unet = unet_pair
    unet = UNet2DConditionModel(unet.cfg)
    unet.load_state_dict(from_jax_params(unet=params)["unet"])
    tree = jax_adapters(params, ALL, 2, 40)
    adapters = lora_from_jax(tree)
    cfg, jcfg = tcfg.LoRAConfig(r=2, lora_alpha=3.0), JaxLoRAConfig(r=2, lora_alpha=3.0)
    x = torch.from_numpy(_np(41, (1, 4, 8, 4)))
    emb, t = torch.from_numpy(_np(42, (1, 8))), torch.tensor([400])
    with torch.no_grad():
        base = unet(x, t, emb)
        unmerged = unet(x, t, emb, lora=adapters, lora_scale=cfg.scale)
        before = {k: v.clone() for k, v in unet.state_dict().items()}
        assert merge_lora(unet, adapters, cfg) is unet
        merged = unet(x, t, emb)
    torch.testing.assert_close(merged, unmerged, atol=1e-5, rtol=0)
    assert (merged - base).abs().max() > 1e-3
    want = from_jax_params(unet=jax_lora.merge_lora(params, tree, jcfg))["unet"]
    changed = 0
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=1e-6, rtol=0)
        changed += int(not torch.equal(v, before[k]))
    assert changed == 32  # the four projections of eight attentions, nothing else
    unmerge_lora(unet, adapters, cfg)
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(v, before[k], atol=1e-6, rtol=0)


def test_merge_lora_casts_the_fp32_delta_to_bf16_weights():
    lin = torch.nn.Module()
    lin.to_q = torch.nn.Linear(8, 8, bias=False).to(torch.bfloat16)
    w0 = lin.to_q.weight.detach().clone()
    a, b = torch.from_numpy(_np(1, (8, 2))), torch.from_numpy(_np(2, (2, 8)))
    merge_lora(lin, LoRAAdapters({"to_q": (a, b)}), tcfg.LoRAConfig(r=2, lora_alpha=4.0))
    assert lin.to_q.weight.dtype == torch.bfloat16
    want = w0.float() + 2.0 * (a @ b).T.to(torch.bfloat16).float()
    torch.testing.assert_close(lin.to_q.weight.float(), want, atol=2e-2, rtol=0)


def test_compose_adapters_matches_jax(unet_pair):
    params, _ = unet_pair
    t1, t2 = jax_adapters(params, ("to_q", "to_v"), 2, 50), jax_adapters(params, ("to_v", "to_out"), 3, 51)
    jparts = [(t1, JaxLoRAConfig(r=2, lora_alpha=4.0, target_modules=("to_q", "to_v")), 0.7),
              (t2, JaxLoRAConfig(r=3, lora_alpha=3.0, target_modules=("to_v", "to_out")), -0.2)]
    parts = [(lora_from_jax(t), tcfg.LoRAConfig(r=c.r, lora_alpha=c.lora_alpha, target_modules=c.target_modules), w)
             for t, c, w in jparts]
    want_tree, want_cfg = jax_lora.compose_adapters(jparts)
    got, cfg = compose_adapters(parts)
    assert (cfg.r, cfg.lora_alpha, tuple(cfg.target_modules)) == (want_cfg.r, want_cfg.lora_alpha, tuple(want_cfg.target_modules))
    assert cfg.scale == 1.0 and cfg.r == 5
    got_flat, want_flat = dict(_flat(lora_to_numpy(got))), dict(_flat(want_tree))
    assert got_flat.keys() == want_flat.keys()
    for k in want_flat:
        np.testing.assert_allclose(got_flat[k], want_flat[k], atol=1e-6, err_msg=k)
    ranks = {a.shape[1] for _, a, _ in got.items()}
    assert ranks == {2, 3, 5}  # to_q only in the first, to_out only in the second, to_v in both
    with pytest.raises(ValueError):
        compose_adapters([])


def test_peft_export_matches_jax_and_imports_back(unet_pair, tmp_path):
    params, _ = unet_pair
    tree = jax_adapters(params, ALL, 2, 60)
    adapters = lora_from_jax(tree)
    want = jax_lora.export_peft_state_dict(tree)
    got = export_peft_state_dict(adapters)
    assert got.keys() == want.keys() and len(got) == 64
    assert any(".to_out.0.lora_A.weight" in k for k in got) and all(k.startswith("base_model.model.") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].is_contiguous()
    # through a file, and the three key layouts peft and diffusers write
    write_safetensors(str(tmp_path / "model.safetensors"), got)
    layouts = {
        "peft": read_safetensors(str(tmp_path / "model.safetensors")),
        "accelerate": {k.replace(".weight", ".default.weight"): v for k, v in got.items()},
        "diffusers": {k.removeprefix("base_model.model.").replace("lora_A", "lora.down").replace("lora_B", "lora.up"): v
                      for k, v in got.items()},
    }
    for name, sd in layouts.items():
        back, rank = import_peft_state_dict(sd)
        jback, jrank = jax_lora.import_peft_state_dict({k: v.numpy() for k, v in sd.items()})
        assert rank == jrank == 2, name
        flat, jflat, orig = dict(_flat(lora_to_numpy(back))), dict(_flat(jback)), dict(_flat(tree))
        assert flat.keys() == jflat.keys() == orig.keys(), name
        for k in orig:
            np.testing.assert_array_equal(flat[k], orig[k])
    assert import_peft_state_dict({"unrelated.weight": torch.zeros(2)})[0].paths() == []


def test_lora_bridge_round_trip(unet_pair):
    params, _ = unet_pair
    tree = jax_adapters(params, ("to_q", "to_v"), 2, 70)
    adapters = lora_from_jax(tree)
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q" in adapters.paths()
    assert all(p.dtype == torch.float32 and p.requires_grad for p in adapters.parameters())
    back, orig = dict(_flat(lora_to_numpy(adapters))), dict(_flat(tree))
    assert back.keys() == orig.keys()
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])
    # only the adapters are parameters of the module an optimizer sees
    assert sum(p.numel() for p in adapters.parameters()) == sum(v.size for v in orig.values())


def test_cli_generate_merges_lora_at_load(jax_modules, checkpoint, tmp_path, capsys):  # noqa: F811
    """``--lora a:0.5 --lora b`` gives the waveform of a UNet merged by hand
    with the same composition, and another one than no adapter."""
    files = []
    for i, (targets, r) in enumerate(((("to_q", "to_v"), 2), (ALL, 3))):
        tree = jax_adapters(jax_modules.unet, targets, r, 80 + i, scale=0.5)
        files.append(str(tmp_path / f"adapter{i}.safetensors"))
        write_safetensors(files[-1], export_peft_state_dict(lora_from_jax(tree)))
    common = ["generate", "--checkpoint", checkpoint, "--prompt", "hip hop music", "--steps", "2",
              "--seconds", str(SECONDS), "--fp32", "--device", "cpu", "--seed", "3"]
    cli.main(common + ["--output", str(tmp_path / "base.wav")])
    cli.main(common + ["--output", str(tmp_path / "lora.wav"), "--lora", files[0] + ":0.5", "--lora", files[1],
                       "--lora-alpha", "4"])
    said = capsys.readouterr().out
    assert "merged LoRA" in said and "r=2, w=0.5" in said and "r=3, w=1.0" in said

    mods = port_gen.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    parts = [(import_peft_state_dict(read_safetensors(f))[0], tcfg.LoRAConfig(r=r, lora_alpha=4.0), w)
             for f, r, w in zip(files, (2, 3), (0.5, 1.0))]
    merge_lora(mods.unet, *compose_adapters(parts))
    ids, mask, u_ids, u_mask = _prompts()
    from audioldm_tpu_torch.data.tokenizer import load_tokenizer

    tok = load_tokenizer(f"{checkpoint}/tokenizer")
    enc, unc = tok(["hip hop music"]), tok([""])
    want = port_gen.generate(mods, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"],
                             seed=3, num_inference_steps=2, audio_length_in_s=SECONDS, dtype=torch.float32, device="cpu")
    import wave

    def read(path):
        with wave.open(path) as w:
            return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16).astype(np.float32) / 32767.0

    got, base = read(str(tmp_path / "lora.wav")), read(str(tmp_path / "base.wav"))
    np.testing.assert_allclose(got, want[0].numpy(), atol=2e-4)  # 16-bit wav quantisation
    assert np.abs(got - base).max() > 1e-3


def test_cli_train_names_the_data_layer(checkpoint, tmp_path):  # noqa: F811
    """cli train runs through the data layer, which refuses an empty folder of clips."""
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="0 items"):
        cli.main(["train", "--checkpoint", checkpoint, "--dataset", str(tmp_path / "empty"), "--output",
                  str(tmp_path / "out"), "--max-steps", "1", "--device", "cpu"])
