"""The port's text-to-audio slice as a whole (audioldm_tpu_torch) against the
JAX package, at tiny widths on the CPU.

The tiny geometry is chosen so that the JAX path runs through BOTH Pallas
kernels (interpret mode): the UNet's level-0 attention has 320 tokens, above
the lowered ``min_tokens`` of 256, and both vocoder stages have C <= 64 and
T >= 256. The port routes the same calls to its kernel wrappers, which run
their plain versions on CPU tensors.
"""

import ast
import importlib
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.ckpt import save_audioldm_checkpoint
from audioldm_tpu.config import ClapTextConfig, DDIMConfig, UNetConfig, VAEConfig, VocoderConfig
from audioldm_tpu.models.clap_text import init_clap_text
from audioldm_tpu.models.unet import init_unet
from audioldm_tpu.models.vae import init_vae
from audioldm_tpu.models.vocoder import init_vocoder
from audioldm_tpu.pipeline import generate as jax_generate
from audioldm_tpu.pipeline.generate import AudioLDMModules as JaxModules
from audioldm_tpu.pipeline.generate import init_noise as jax_init_noise
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import from_jax_params
from audioldm_tpu_torch.kernels import flash_attention as port_fa
from audioldm_tpu_torch.kernels import mrf_conv as port_mrf
from audioldm_tpu_torch.pipeline import generate as port_gen
from test_torch_port_models import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = dict(vocab_size=300, hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=514, projection_dim=8)
UNET = dict(
    in_channels=4, out_channels=4, block_out_channels=(8, 16),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=2,
    projection_class_embeddings_input_dim=8,
)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4, scaling_factor=0.9)
VOC = dict(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3)
SECONDS = 0.04  # 160 mel frames -> latents [B, 4, 80, 4]: 320 level-0 tokens; vocoder stages T=320, 640


@pytest.fixture(scope="module")
def jax_modules():
    return JaxModules(
        unet=numpy_params(init_unet, UNetConfig(**UNET), 10),
        vae=numpy_params(init_vae, VAEConfig(**VAE), 11),
        text_encoder=numpy_params(init_clap_text, ClapTextConfig(**TEXT), 12),
        vocoder=numpy_params(init_vocoder, VocoderConfig(**VOC), 13),
        unet_cfg=UNetConfig(**UNET), vae_cfg=VAEConfig(**VAE), text_cfg=ClapTextConfig(**TEXT),
        vocoder_cfg=VocoderConfig(**VOC), ddim_cfg=DDIMConfig(),
    )


def port_modules(jm) -> port_gen.AudioLDMModules:
    sds = from_jax_params(unet=jm.unet, vae=jm.vae, text_encoder=jm.text_encoder, vocoder=jm.vocoder)
    mods = port_gen.random_modules(
        0, tcfg.UNetConfig(**UNET), tcfg.VAEConfig(**VAE), tcfg.ClapTextConfig(**TEXT), tcfg.VocoderConfig(**VOC),
        device="cpu",
    )
    for name, sd in sds.items():
        getattr(mods, name).load_state_dict(sd, strict=True)
    return mods


def _prompts(b=1):
    ids = np.array([[0, 45, 77, 12, 9, 2, 1, 1]] * b, np.int32)
    u_ids = np.array([[0, 2, 1, 1, 1, 1, 1, 1]], np.int32)
    return ids, (ids != 1).astype(np.int32), u_ids, (u_ids != 1).astype(np.int32)


def test_slice_matches_jax_through_both_kernels(jax_modules, monkeypatch):
    """3 DDIM steps, CFG 2.5, fp32, the port given the JAX init latents:
    waveform within the 2e-3 trajectory tolerance."""
    jfa = importlib.import_module("audioldm_tpu.kernels.flash_attention")
    for name, value in (("_ENABLED", True), ("_FORCE_INTERPRET", True), ("_MIN_TOKENS", 256), ("_flash_jits", {})):
        monkeypatch.setattr(jfa, name, value)
    monkeypatch.setattr(importlib.import_module("audioldm_tpu.kernels.mrf_conv"), "_ENABLED", True)
    monkeypatch.setattr(port_fa, "_MIN_TOKENS", 256)
    ids, mask, u_ids, u_mask = (jnp.asarray(a) for a in _prompts())
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(jax_generate(jax_modules, ids, mask, u_ids, u_mask, rng, num_inference_steps=3,
                                  audio_length_in_s=SECONDS, guidance_scale=2.5))
    lat, _ = jax_init_noise(jax_modules, rng, 1, SECONDS)

    counts = {"flash": [], "mrf": []}
    fa_orig, mrf_orig = port_fa.flash_attention, port_mrf.mrf_stage
    monkeypatch.setattr(port_fa, "flash_attention", lambda q, k, v: counts["flash"].append(q.shape) or fa_orig(q, k, v))
    monkeypatch.setattr(port_mrf, "mrf_stage", lambda x, *a, **k: counts["mrf"].append(tuple(x.shape)) or mrf_orig(x, *a, **k))
    out = port_gen.generate(
        port_modules(jax_modules), *_prompts(), num_inference_steps=3, audio_length_in_s=SECONDS,
        guidance_scale=2.5, dtype=torch.float32, latents=torch.from_numpy(np.array(lat).transpose(0, 3, 1, 2)),
        device="cpu",
    ).numpy()
    assert out.shape == ref.shape == (1, int(SECONDS * 16000))
    np.testing.assert_allclose(out, ref, atol=2e-3)
    # level-0 attn1 + attn2: 1 down + 2 up transformers, one UNet call per step
    assert counts["flash"] == [(2, 2, 320, 4)] * 18
    assert counts["mrf"] == [(1, 8, 320), (1, 4, 640)]


def _write_tokenizer(folder):
    from audioldm_tpu_torch.data.tokenizer import bytes_to_unicode

    os.makedirs(folder, exist_ok=True)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


@pytest.fixture(scope="module")
def checkpoint(jax_modules, tmp_path_factory):
    """A tiny HF-layout directory written by the JAX package."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    save_audioldm_checkpoint(d, jax_modules)
    _write_tokenizer(os.path.join(d, "tokenizer"))
    return d


def test_checkpoint_loads_strict_and_reproduces(jax_modules, checkpoint):
    loaded = port_gen.AudioLDMModules.from_checkpoint(checkpoint, device="cpu")
    carried = port_modules(jax_modules)
    for name in ("unet", "vae", "text_encoder", "vocoder"):
        a, b = getattr(loaded, name).state_dict(), getattr(carried, name).state_dict()
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert loaded.ddim_cfg == carried.ddim_cfg
    kw = dict(seed=5, num_inference_steps=2, audio_length_in_s=SECONDS, dtype=torch.float32, device="cpu")
    torch.testing.assert_close(port_gen.generate(loaded, *_prompts(), **kw), port_gen.generate(carried, *_prompts(), **kw),
                               rtol=0, atol=0)


def test_legacy_vae_attention_names_load(jax_modules, checkpoint, tmp_path):
    """Older diffusers VAE checkpoints name the mid-block attention
    query/key/value/proj_attn."""
    import shutil

    from safetensors.numpy import load_file, save_file

    d = str(tmp_path / "legacy")
    shutil.copytree(checkpoint, d)
    f = os.path.join(d, "vae", "diffusion_pytorch_model.safetensors")
    legacy = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}
    sd = {}
    for k, v in load_file(f).items():
        for new, old in legacy.items():
            k = k.replace(new, old)
        sd[k] = v
    assert any(".proj_attn." in k for k in sd)
    save_file(sd, f)
    loaded = port_gen.AudioLDMModules.from_checkpoint(d, device="cpu").vae.state_dict()
    carried = port_modules(jax_modules).vae.state_dict()
    assert loaded.keys() == carried.keys()
    for k in loaded:
        torch.testing.assert_close(loaded[k], carried[k], rtol=0, atol=0)


def test_row_latents_depend_only_on_seed_and_row(jax_modules):
    mods = port_modules(jax_modules)
    one = port_gen.init_noise(mods, 7, 1, SECONDS)
    three = port_gen.init_noise(mods, 7, 3, SECONDS)
    assert three.shape == (3, 4, 80, 4)
    torch.testing.assert_close(three[:1], one, rtol=0, atol=0)
    assert not torch.equal(three[0], three[1])
    assert not torch.equal(port_gen.init_noise(mods, 8, 1, SECONDS), one)


def test_bf16_generation_is_finite(jax_modules):
    mods = port_modules(jax_modules)
    wav = port_gen.generate(mods, *_prompts(2), num_inference_steps=2, audio_length_in_s=SECONDS, device="cpu")
    assert wav.dtype == torch.float32 and wav.shape == (2, 640)
    assert torch.isfinite(wav).all() and wav.abs().max() <= 1.0
    assert mods.unet.conv_in.weight.dtype == torch.bfloat16
    assert mods.unet.conv_norm_out.weight.dtype == torch.float32  # norms stay fp32
    assert mods.vocoder.conv_pre.weight.dtype == torch.float32


def test_cli_generate_writes_wavs(checkpoint, tmp_path, capsys):
    out = str(tmp_path / "g.wav")
    # --tp 1 runs the tensor-parallel path over a group of one process (gloo on the CPU)
    cli.main(["generate", "--checkpoint", checkpoint, "--prompt", "hip hop music", "--steps", "2",
              "--seconds", str(SECONDS), "--batch", "2", "--fp32", "--device", "cpu", "--output", out, "--tp", "1"])
    assert "wrote 2 clips" in capsys.readouterr().out
    for i in range(2):
        with wave.open(str(tmp_path / f"g_{i}.wav")) as w:
            assert (w.getframerate(), w.getnframes()) == (16000, 640)


@pytest.mark.parametrize("flags,part", [
    (["--tp", "2"], "needs 2 processes, but 1 is running: launch with python -m torch.distributed.run"),
])
def test_cli_refuses_flags_of_later_slices(flags, part):
    with pytest.raises(SystemExit, match=part):
        cli.main(["generate", "--checkpoint", "unused", "--prompt", "x", "--device", "cpu"] + flags)


@pytest.mark.parametrize("flags,says", [
    (["--best-of", "1", "--clap", "c"], "N >= 2 and --batch 1"),
    (["--best-of", "2", "--batch", "2", "--clap", "c"], "N >= 2 and --batch 1"),
    (["--best-of", "2"], "needs --clap"),
    (["--best-of", "2", "--clap", "c", "--init-audio", "src.wav"], "not combinable with .*--best-of"),
])
def test_cli_best_of_refuses_as_jax_does(checkpoint, flags, says):
    """``--best-of``'s refusals are the JAX CLI's, on the same flags (the
    JAX CLI loads the checkpoint before it checks them)."""
    from audioldm_tpu import cli as jax_cli

    argv = ["generate", "--checkpoint", checkpoint, "--prompt", "x", "--output", "unused.wav"] + flags
    with pytest.raises(SystemExit, match=says):
        jax_cli.main(argv)
    with pytest.raises(SystemExit, match=says):
        cli.main(argv + ["--device", "cpu"])


def test_entry_points_need_a_gpu_unless_asked_for_cpu(jax_modules, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mods = port_modules(jax_modules)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_gen.generate(mods, *_prompts(), num_inference_steps=1, audio_length_in_s=SECONDS)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_gen.random_modules(0)
    assert mods.device.type == "cpu"  # nothing moved


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "audioldm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for new in ("data/dataset.py", "data/plugins_meta.py", "data/native.py", "ops/kaldi.py", "utils/logging.py",
                "train/validation.py", "tools/bench_dataprep.py",  # the data layer and cli train's modules
                "models/clap_audio.py", "eval/clap_features.py", "eval/metrics.py", "eval/scoring.py",
                "tools/eval_drill.py",  # CLAP evaluation
                "train/distill.py", "tools/ckpt_drill.py", "tools/bench_serving.py", "utils/flops.py",  # distillation, the drill, the bench
                "parallel/mesh.py", "parallel/tp.py", "ops/invert.py", "utils/profiling.py", "utils/fastinit.py",
                "utils/tools.py",  # parallelism and the tail
                "tools/benchkit.py", "tools/bench_unet_step.py", "tools/check_perf.py", "tools/bench_train_step.py",
                "tools/bench_pipeline_tail.py", "tools/bench_vocoder_mrf.py", "tools/bench_a2a.py",
                "tools/bench_guidance_interval.py", "tools/bench_longform.py", "tools/quality_proximity.py",
                "tools/profile_pipeline.py", "tools/read_trace.py", "tools/bench_compile.py", "tools/bench_matmul.py",
                "tools/bench_conv1d_smallc.py",  # the system's tools
                "tools/fp32_step.py"):  # the `generate --fp32` step's profile
        assert os.path.join(REPO, "audioldm_tpu_torch", new) in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            # ``tools`` is the repo root's package of the JAX system's tools
            assert top not in ("jax", "jaxlib", "audioldm_tpu", "flax", "optax", "tools"), f"{path} imports {mod}"
