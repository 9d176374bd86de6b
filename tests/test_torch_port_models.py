"""Each model of the port (audioldm_tpu_torch/models) against its JAX
counterpart at tiny widths, on the same numpy-seeded weights (a JAX
parameter tree carried into the port with ``from_jax_params``) and inputs. Tolerance 1e-4, the test_torch_oracle
convention for tiny geometry.

The UNet case routes the port's level-0 attention through its flash
wrapper (lowered ``min_tokens``; the plain version on the CPU). The vocoder
cases route through the MRF kernel in both packages: the JAX Pallas kernel in
interpret mode, the port's wrapper through its plain version. The kernels
themselves are held against the Pallas ones in test_torch_port_kernels.py,
and the whole slice with both JAX kernels on in test_torch_port_pipeline.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import ClapTextConfig, DDIMConfig, UNetConfig, VAEConfig, VocoderConfig
from audioldm_tpu.models import scheduler as jax_sched
from audioldm_tpu.models import vae as jax_vae
from audioldm_tpu.models.clap_text import apply_clap_text, init_clap_text
from audioldm_tpu.models.nn import group_norm as jax_group_norm
from audioldm_tpu.models.nn import timestep_embedding as jax_timestep_embedding
from audioldm_tpu.models.unet import apply_unet, init_unet
from audioldm_tpu.models.vocoder import apply_vocoder, init_vocoder
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import from_jax_params
from audioldm_tpu_torch.kernels import flash_attention as port_fa
from audioldm_tpu_torch.kernels import mrf_conv as port_mrf
from audioldm_tpu_torch.models import nn as port_nn
from audioldm_tpu_torch.models import scheduler as port_sched
from audioldm_tpu_torch.models.clap_text import ClapTextModelWithProjection
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.models.vae import AutoencoderKL
from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan

UNET = dict(
    in_channels=4, out_channels=4, block_out_channels=(8, 16),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=2,
    projection_class_embeddings_input_dim=8,
)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4, scaling_factor=0.9)
TEXT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=40, projection_dim=8)
VOC = dict(model_in_dim=8, upsample_initial_channel=32, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3)


def numpy_params(init_fn, cfg, seed: int) -> dict:
    """A JAX parameter tree shaped as ``init_fn(key, cfg)`` makes it, filled
    from a numpy seed (the JAX initialisers take tens of seconds to trace at
    these sizes): kernels uniform in ±1/sqrt(fan_in), biases and norm
    offsets N(0, 0.1), norm gains 1 + N(0, 0.1), embeddings N(0, 0.02)."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))

    def fill(path, leaf):
        name, shape = str(getattr(path[-1], "key", "")), leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return r.uniform(-bound, bound, shape).astype(np.float32)
        if name == "embedding":
            return (0.02 * r.standard_normal(shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * np.abs(r.standard_normal(shape))).astype(np.float32)
        return (0.1 * r.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(model, state):
    model.load_state_dict(state, strict=True)
    return model.eval()


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_unet_matches_jax(monkeypatch):
    params = numpy_params(init_unet, UNetConfig(**UNET), 0)
    unet = _port(UNet2DConditionModel(tcfg.UNetConfig(**UNET)), from_jax_params(unet=params)["unet"])
    x = _np(1, (2, 16, 8, 4))  # NHWC; level 0 has 128 tokens (routed), level 1 32
    emb = _np(2, (2, 8))
    t = np.array([999, 21])
    ref = np.asarray(jax.jit(apply_unet, static_argnums=1)(params, UNetConfig(**UNET), jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb)))
    monkeypatch.setattr(port_fa, "_MIN_TOKENS", 64)
    calls = []
    orig = port_fa.flash_attention
    monkeypatch.setattr(port_fa, "flash_attention", lambda q, k, v: calls.append(q.shape) or orig(q, k, v))
    with torch.no_grad():
        out = unet(torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(t), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(out, ref.transpose(0, 3, 1, 2), atol=1e-4)
    # attn1 + attn2 of the level-0 transformers: 1 down + 2 up
    assert calls == [(2, 2, 128, 4)] * 6


def test_unet_odd_latent_size_matches_jax():
    """A 10.0 s clip's odd latent sizes: nearest upsampling back to the skip's size."""
    params = numpy_params(init_unet, UNetConfig(**UNET), 3)
    unet = _port(UNet2DConditionModel(tcfg.UNetConfig(**UNET)), from_jax_params(unet=params)["unet"])
    x = _np(4, (1, 25, 4, 4))
    emb = _np(5, (1, 8))
    t = np.array([500])
    ref = np.asarray(jax.jit(apply_unet, static_argnums=1)(params, UNetConfig(**UNET), jnp.asarray(x), jnp.asarray(t), jnp.asarray(emb)))
    with torch.no_grad():
        out = unet(torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(t), torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(out, ref.transpose(0, 3, 1, 2), atol=1e-4)


def test_vae_decode_matches_jax():
    params = numpy_params(jax_vae.init_vae, VAEConfig(**VAE), 1)
    vae = _port(AutoencoderKL(tcfg.VAEConfig(**VAE)), from_jax_params(vae=params)["vae"])
    z = _np(6, (2, 6, 4, 4))
    ref = np.asarray(jax.jit(jax_vae.decode, static_argnums=1)(params, VAEConfig(**VAE), jnp.asarray(z)))
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(out, ref.transpose(0, 3, 1, 2), atol=1e-4)


@pytest.mark.parametrize("frames", [80, 160])
def test_vocoder_matches_jax(monkeypatch, frames):
    """80 mel frames: stage 0 (T=160) runs plain, stage 1 (T=320) through
    the MRF kernel with the conv_post epilogue; 160 frames: both stages
    through the kernel."""
    monkeypatch.setattr(importlib.import_module("audioldm_tpu.kernels.mrf_conv"), "_ENABLED", True)
    params = numpy_params(init_vocoder, VocoderConfig(**VOC), 2)
    voc = _port(SpeechT5HifiGan(tcfg.VocoderConfig(**VOC)), from_jax_params(vocoder=params)["vocoder"])
    mel = _np(7, (1, frames, 8))
    ref = np.asarray(jax.jit(apply_vocoder, static_argnums=1)(params, VocoderConfig(**VOC), jnp.asarray(mel)))
    calls = []
    orig = port_mrf.mrf_stage
    monkeypatch.setattr(port_mrf, "mrf_stage", lambda x, *a, **kw: calls.append(tuple(x.shape)) or orig(x, *a, **kw))
    with torch.no_grad():
        out = voc(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (1, frames * 4)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert calls == ([(1, 8, 320)] if frames == 80 else [(1, 16, 320), (1, 8, 640)])


def test_clap_text_matches_jax():
    params = numpy_params(init_clap_text, ClapTextConfig(**TEXT), 4)
    model = _port(ClapTextModelWithProjection(tcfg.ClapTextConfig(**TEXT)), from_jax_params(text_encoder=params)["text_encoder"])
    ids = np.array([[0, 5, 9, 33, 2, 1, 1], [0, 7, 2, 1, 1, 1, 1]], np.int32)
    mask = (ids != 1).astype(np.int32)
    ref = jax.jit(apply_clap_text, static_argnums=1)(params, ClapTextConfig(**TEXT), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    for key in ("text_embeds", "pooler_output", "last_hidden_state"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4)


@pytest.mark.parametrize("prediction_type,clip_sample", [("epsilon", False), ("v_prediction", False), ("sample", True)])
def test_ddim_matches_jax(prediction_type, clip_sample):
    kw = dict(prediction_type=prediction_type, clip_sample=clip_sample)
    cfg_j, cfg_t = DDIMConfig(**kw), tcfg.DDIMConfig(**kw)
    sj, st = jax_sched.make_schedule(cfg_j), port_sched.make_schedule(cfg_t)
    np.testing.assert_allclose(st.alphas_cumprod.numpy(), np.asarray(sj.alphas_cumprod), rtol=1e-6)
    ts = port_sched.inference_timesteps(cfg_t, 50)
    np.testing.assert_array_equal(ts, np.asarray(jax_sched.inference_timesteps(cfg_j, 50)))
    x, eps = _np(8, (2, 4, 6, 4)), _np(9, (2, 4, 6, 4))
    for t, prev in ((981, 961), (21, 1), (1, -19)):
        ref = np.asarray(jax_sched.ddim_step(sj, jnp.asarray(eps), t, prev, jnp.asarray(x)))
        out = port_sched.ddim_step(st, torch.from_numpy(eps), t, prev, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)
    noise, tt = _np(10, (2, 4, 6, 4)), np.array([10, 900])
    ref = np.asarray(jax_sched.add_noise(sj, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(tt)))
    out = port_sched.add_noise(st, torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(tt)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_nn_primitives_match_jax():
    x = _np(11, (2, 5, 3, 16)) * 3 + 1
    w, b = _np(12, (16,)), _np(13, (16,))
    ref = np.asarray(jax_group_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), 4, 1e-6))
    norm = torch.nn.GroupNorm(4, 16, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        norm.bias.copy_(torch.from_numpy(b))
        out = port_nn.group_norm(torch.from_numpy(x.transpose(0, 3, 1, 2)), norm).numpy()
    np.testing.assert_allclose(out, ref.transpose(0, 3, 1, 2), atol=1e-5)
    t = np.array([0, 1, 500, 999])
    ref = np.asarray(jax_timestep_embedding(jnp.asarray(t), 32))
    np.testing.assert_allclose(port_nn.timestep_embedding(torch.from_numpy(t), 32).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("model", ["clap_text", "vocoder"])
def test_transformers_checkpoints_load_strictly(model, tmp_path):
    """A transformers model's safetensors file, read by the port's own numpy
    reader, loads into the port with strict=True and gives the same output."""
    from safetensors.torch import save_file

    from audioldm_tpu_torch.ckpt import load_state_dict

    torch.manual_seed(0)
    if model == "clap_text":
        from transformers import ClapTextConfig as HFConfig
        from transformers import ClapTextModelWithProjection as HFModel

        hf = HFModel(HFConfig(**TEXT, type_vocab_size=1, pad_token_id=1)).eval()
        port = ClapTextModelWithProjection(tcfg.ClapTextConfig(**TEXT))
        ids = np.array([[0, 5, 9, 33, 2, 1, 1], [0, 7, 2, 1, 1, 1, 1]])
        inputs = (torch.from_numpy(ids), torch.from_numpy((ids != 1).astype(np.int64)))
        run_hf = lambda: hf(input_ids=inputs[0], attention_mask=inputs[1]).text_embeds
        run_port = lambda: port(*inputs)["text_embeds"]
    else:
        from transformers import SpeechT5HifiGan as HFModel
        from transformers import SpeechT5HifiGanConfig as HFConfig

        hf = HFModel(HFConfig(**VOC)).eval()
        with torch.no_grad():
            hf.mean.normal_(0, 0.5)
            hf.scale.uniform_(0.5, 1.5)
        port = SpeechT5HifiGan(tcfg.VocoderConfig(**VOC))
        mel = torch.from_numpy(_np(14, (2, 17, 8)))
        run_hf, run_port = (lambda: hf(mel)), (lambda: port(mel))
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()}, str(tmp_path / "model.safetensors"))
    port.load_state_dict(load_state_dict(str(tmp_path)), strict=True)
    port.eval()
    with torch.no_grad():
        torch.testing.assert_close(run_port(), run_hf(), atol=2e-5, rtol=1e-5)
