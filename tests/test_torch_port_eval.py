"""The port's CLAP evaluation (audioldm_tpu_torch: ``models/clap_audio.py``,
``eval/clap_features.py``, ``eval/metrics.py``, ``eval/scoring.py``) against
the JAX package and transformers, fp32 on the CPU.

The HTSAT tower runs at the TINY geometry of tests/test_clap_audio.py, on a
numpy-seeded JAX tree (bias tables and BatchNorm statistics random, so that
a dropped key or a wrong axis shows) carried over by
``from_jax_params(clap_audio=)``, and on transformers' weights loaded with
``strict=True``. The scorer runs on a CLAP directory of the tiny geometry
of tests/test_cli.py (the real 48 kHz feature geometry: 64 mel bins, spec
256), its bias tables and BatchNorm statistics random, scoring clips of
tones: white-noise clips through an untrained tower give embeddings within
3e-3 of each other, and a KAD whose bandwidth is that small turns fp32
rounding in either package into a 1e-3 change. Bounds: 1e-4 against JAX
(the tiny-geometry convention), 5e-4 against transformers (the JAX
package's own bound), KAD 1e-3 (x100 scale).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.ckpt import convert_clap_audio_state
from audioldm_tpu.config import ClapAudioConfig as JaxClapAudioConfig
from audioldm_tpu.data.wavio import write_wav
from audioldm_tpu.eval import clap_features as jax_features
from audioldm_tpu.eval import metrics as jax_metrics
from audioldm_tpu.eval.scoring import ClapScorer as JaxClapScorer
from audioldm_tpu.models.clap_audio import apply_clap_audio, init_clap_audio
from audioldm_tpu_torch.ckpt import from_jax_params
from audioldm_tpu_torch.config import ClapAudioConfig, UnsupportedConfigError
from audioldm_tpu_torch.eval import clap_features, metrics
from audioldm_tpu_torch.eval.scoring import ClapScorer, score_directories
from audioldm_tpu_torch.models.clap_audio import ClapAudioModelWithProjection
from test_torch_port_models import numpy_params
from audioldm_tpu_torch.tools.eval_drill import randomize_untrained, write_tokenizer_files
from tests.test_clap_audio import TINY

FULL = {}  # laion/clap-htsat-fused: the config defaults
# the JAX references, jitted: eager dispatch compiles each op of a first call
# apart, 5-8x slower here than one program
jax_tower = jax.jit(apply_clap_audio, static_argnums=1)
jax_kad = jax.jit(jax_metrics.kernel_audio_distance, static_argnames=("kernel",))
jax_median = jax.jit(jax_metrics.median_pairwise_distance)


def _transformers():
    """Import transformers without TensorFlow, which no test here uses and
    whose import costs 9 s of a worker's time (``USE_TF`` is read when
    transformers is first imported)."""
    os.environ.setdefault("USE_TF", "0")
    import transformers

    return transformers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool of threads only waits
    for its members, and slows by orders of magnitude when test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(geometry):
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in geometry.items()}
    return JaxClapAudioConfig(**d), ClapAudioConfig.from_hf(d)


def clap_audio_tree(jcfg, seed: int) -> dict:
    """A JAX tower tree from a numpy seed, with random bias tables (zero at
    init) and BatchNorm statistics (identity at init; variances in [0.5,
    1.5])."""
    r = np.random.default_rng(seed + 1)

    def fix(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name in ("relative_position_bias_table", "running_mean"):
            return (0.5 * r.standard_normal(leaf.shape)).astype(np.float32)
        if name == "running_var":
            return r.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, numpy_params(init_clap_audio, jcfg, seed))


def port_tower(cfg, tree) -> ClapAudioModelWithProjection:
    model = ClapAudioModelWithProjection(cfg)
    model.load_state_dict(from_jax_params(clap_audio=tree)["clap_audio"], strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def hf_tower():
    """transformers' tower at TINY, bias tables and BN statistics random."""
    tf = _transformers()
    torch.manual_seed(0)
    model = tf.ClapAudioModelWithProjection(tf.ClapAudioConfig(**TINY)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "relative_position_bias_table" in n:
                p.copy_(0.5 * torch.randn(p.shape, generator=g))
        for n, b in model.named_buffers():
            if "running_mean" in n:
                b.copy_(0.5 * torch.randn(b.shape, generator=g))
            elif "running_var" in n:
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model


# (T, is_longer): T = 63 reaches the align-corners bicubic time resize (63 -> 64)
CASES = [(63, (False, False)), (64, (True, False))]


@pytest.mark.parametrize("frames,longer", CASES)
def test_htsat_matches_jax(frames, longer):
    jcfg, cfg = _cfgs(TINY)
    tree = clap_audio_tree(jcfg, 3)
    feats = np.random.default_rng(frames).standard_normal((2, 4, frames, 16)).astype(np.float32)
    want = jax_tower(tree, jcfg, jnp.asarray(feats), jnp.asarray(longer))
    with torch.no_grad():
        got = port_tower(cfg, tree)(torch.from_numpy(feats), torch.tensor(longer))
    for k in ("audio_embeds", "pooler_output", "last_hidden_state"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    assert np.abs(np.asarray(want["audio_embeds"])).max() > 1e-3


@pytest.mark.parametrize("frames,longer", CASES)
def test_htsat_matches_transformers_loaded_strictly(hf_tower, frames, longer):
    model = ClapAudioModelWithProjection(ClapAudioConfig.from_hf(TINY)).eval()
    model.load_state_dict({k: v for k, v in hf_tower.state_dict().items() if not k.endswith("num_batches_tracked")},
                          strict=True)
    feats = torch.from_numpy(np.random.default_rng(frames).standard_normal((2, 4, frames, 16)).astype(np.float32))
    with torch.no_grad():
        got = model(feats, torch.tensor(longer))["audio_embeds"]
        want = hf_tower(feats, is_longer=torch.tensor(longer)[:, None]).audio_embeds
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


def test_htsat_state_dict_is_transformers_and_from_jax_params(hf_tower):
    jcfg, cfg = _cfgs(TINY)

    def shapes(sd):
        return {k: tuple(v.shape) for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    ours = shapes(ClapAudioModelWithProjection(cfg).state_dict())
    assert ours == shapes(hf_tower.state_dict())
    assert ours == shapes(from_jax_params(clap_audio=clap_audio_tree(jcfg, 3))["clap_audio"])
    converted = convert_clap_audio_state({k: v.numpy() for k, v in hf_tower.state_dict().items()})
    carried = from_jax_params(clap_audio=converted)["clap_audio"]
    for k, v in carried.items():  # the JAX converter and from_jax_params are inverses
        torch.testing.assert_close(v.to(hf_tower.state_dict()[k].dtype), hf_tower.state_dict()[k], rtol=0, atol=0)


def test_clap_audio_config_from_hf_drops_unknown_keys():
    cfg = ClapAudioConfig.from_hf({**TINY, "model_type": "clap_audio_model", "hidden_dropout_prob": 0.1})
    assert cfg.depths == (2, 2) and cfg.freq_ratio == 2
    assert ClapAudioConfig().freq_ratio == 4 and ClapAudioConfig().enable_fusion
    assert ClapAudioConfig.from_hf({**TINY, "patch_stride": 4, "num_classes": 3}) == cfg
    for variant in (dict(patch_stride=(2, 4)), dict(flatten_patch_embeds=False), dict(fusion_type="channel_map")):
        with pytest.raises(UnsupportedConfigError, match="not implemented|differs"):
            ClapAudioConfig.from_hf({**TINY, **variant})


@pytest.mark.slow
def test_htsat_full_geometry_matches_jax():
    jcfg, cfg = _cfgs(FULL)
    tree = clap_audio_tree(jcfg, 4)
    feats = (3.0 * np.random.default_rng(5).standard_normal((2, 4, 1001, 64))).astype(np.float32)
    longer = (True, False)
    want = np.asarray(jax_tower(tree, jcfg, jnp.asarray(feats), jnp.asarray(longer))["audio_embeds"])
    with torch.no_grad():
        got = port_tower(cfg, tree)(torch.from_numpy(feats), torch.tensor(longer))["audio_embeds"].numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


# -- features ----------------------------------------------------------------


@pytest.mark.parametrize("n_samples", [48000 * 3, clap_features.MAX_SAMPLES, clap_features.MAX_SAMPLES + 96000])
def test_fused_features_match_jax(n_samples):
    wav = (np.random.default_rng(n_samples).standard_normal(n_samples) * 0.2).astype(np.float32)
    got, got_longer = clap_features.extract_fused_features(wav, np.random.default_rng(9))
    want, want_longer = jax_features.extract_fused_features(wav, np.random.default_rng(9))
    assert got_longer == want_longer == (n_samples > clap_features.MAX_SAMPLES)
    assert got.shape == (4, 1001, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if got_longer:  # three different crops
        assert not np.array_equal(got[1], got[2]) and not np.array_equal(got[2], got[3])


def test_batch_fused_features_match_jax_with_the_per_clip_quirk():
    r = np.random.default_rng(2)
    wavs = [(r.standard_normal(n) * 0.2).astype(np.float32) for n in (48000, clap_features.MAX_SAMPLES + 50000)]
    feats, longer = clap_features.batch_fused_features(wavs, np.random.default_rng(4))
    jf, jl = jax_features.batch_fused_features(wavs, np.random.default_rng(4))  # per_clip_batches=True, its default
    assert feats.dtype == torch.float32 and longer.dtype == torch.bool and feats.device.type == "cpu"
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    assert longer.tolist() == np.asarray(jl).tolist() == [True, True]  # the 1 s clip too: the quirk


# -- metrics -----------------------------------------------------------------


def _sets(seed=0):
    r = np.random.default_rng(seed)
    return r.standard_normal((6, 8)).astype(np.float32), (r.standard_normal((5, 8)) + 0.3).astype(np.float32)


def _kad_terms(x, y, kernel, bandwidth=None) -> float:
    """``100 (|mean Kxx| + |mean Kyy| + 2 |mean Kxy|)`` in float64: the size
    of the three terms whose difference KAD is. fp32 rounds each to about
    6e-8 of itself, so this, not KAD, is what a relative bound is taken of."""
    x, y = np.float64(x), np.float64(y)
    if bandwidth is None:
        d = np.linalg.norm(y[:, None] - y[None], axis=-1)[np.triu_indices(len(y), 1)]
        bandwidth = np.sort(d)[(len(d) - 1) // 2] if np.sort(d)[(len(d) - 1) // 2] >= 1e-6 else 1.0
    gamma = 1.0 / (2.0 * bandwidth**2 + 1e-8)
    k = {"gaussian": lambda d2: np.exp(-gamma * d2), "iq": lambda d2: 1 / (1 + gamma * d2),
         "imq": lambda d2: 1 / np.sqrt(1 + gamma * d2)}[kernel]

    def mean(a, b, off_diagonal):
        m = k(((a[:, None] - b[None]) ** 2).sum(-1))
        return (m.sum() - np.trace(m)) / (len(a) * (len(a) - 1)) if off_diagonal else m.mean()

    return 100.0 * (abs(mean(x, x, True)) + abs(mean(y, y, True)) + 2 * abs(mean(x, y, False)))


@pytest.mark.parametrize("kernel", ["gaussian", "iq", "imq"])
def test_kad_matches_jax(kernel):
    x, y = _sets()
    got = metrics.kernel_audio_distance(torch.from_numpy(x), torch.from_numpy(y), kernel=kernel)
    want = jax_kad(jnp.asarray(x), jnp.asarray(y), kernel=kernel)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5 * _kad_terms(x, y, kernel))
    assert abs(got.item()) > 1e-3


def test_kad_edges_match_jax():
    x, y = _sets(1)
    same = metrics.kernel_audio_distance(torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(same.item(), float(jax_kad(jnp.asarray(x), jnp.asarray(x))),
                               rtol=0, atol=1e-5 * _kad_terms(x, x, "gaussian"))
    assert same.item() < 0  # the cross term's mean holds the diagonal's ones, the within terms' do not
    flat = np.repeat(y[:1], 4, axis=0)  # every generated embedding equal: the bandwidth falls back to 1.0
    got = metrics.kernel_audio_distance(torch.from_numpy(x), torch.from_numpy(flat))
    want = jax_kad(jnp.asarray(x), jnp.asarray(flat))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5 * _kad_terms(x, flat, "gaussian", 1.0))
    np.testing.assert_allclose(got.item(), float(jax_metrics.kernel_audio_distance(jnp.asarray(x), jnp.asarray(flat),
                                                                                bandwidth=1.0)),
                               rtol=0, atol=1e-5 * _kad_terms(x, flat, "gaussian", 1.0))
    with pytest.raises(ValueError, match=">= 2 embeddings"):
        metrics.kernel_audio_distance(torch.from_numpy(x), torch.from_numpy(y[:1]))


def test_median_pairwise_distance_and_similarity_match_jax():
    x, y = _sets(2)
    got = metrics.median_pairwise_distance(torch.from_numpy(x))
    np.testing.assert_allclose(got.item(), float(jax_median(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(got.item(), torch.median(torch.pdist(torch.from_numpy(x))).item(), rtol=1e-5)
    # the subsample branch: the median of the pairs drawn from the generator
    g = torch.Generator().manual_seed(3)
    i1, i2 = torch.randint(0, 6, (7,), generator=g), torch.randint(0, 6, (7,), generator=g)
    i2 = torch.where(i1 == i2, (i2 + 1) % 6, i2)
    d = torch.sort(torch.linalg.norm(torch.from_numpy(x)[i1] - torch.from_numpy(x)[i2], dim=1)).values
    sub = metrics.median_pairwise_distance(torch.from_numpy(x), subsample=7, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(sub, d[3])
    sim = metrics.clap_similarity(torch.from_numpy(x[:5]), torch.from_numpy(y))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jax.jit(jax_metrics.clap_similarity)(jnp.asarray(x[:5]), jnp.asarray(y))),
                               rtol=1e-5)


# -- the scorer --------------------------------------------------------------

CLAP_TEXT = dict(vocab_size=512, hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=100, projection_dim=8)
CLAP_AUDIO = dict(window_size=4, num_mel_bins=64, spec_size=256, patch_size=4, patch_stride=[4, 4],
                  patch_embeds_hidden_size=4, depths=[1, 1], num_attention_heads=[1, 2], hidden_size=8, projection_dim=8,
                  enable_fusion=True, aff_block_r=4)


@pytest.fixture(scope="module")
def clap_dir(tmp_path_factory):
    """A tiny HF-layout CLAP directory: transformers' ``ClapModel`` with
    random bias tables and BatchNorm statistics, and the test tokenizer."""
    from audioldm_tpu_torch.ckpt import write_safetensors

    tf = _transformers()
    d = str(tmp_path_factory.mktemp("clap"))
    torch.manual_seed(0)
    model = tf.ClapModel(tf.ClapConfig(text_config=CLAP_TEXT, audio_config=CLAP_AUDIO, projection_dim=8)).eval()
    randomize_untrained(model, 0)
    write_safetensors(os.path.join(d, "model.safetensors"), model.state_dict())
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"text_config": CLAP_TEXT, "audio_config": CLAP_AUDIO}, f)
    write_tokenizer_files(d)
    return d


def tones(seed, lengths, sr=48000):
    """Seeded clips of three tones and noise, 0.4 peak."""
    r = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / sr
        w = sum(r.uniform(0.05, 0.15) * np.sin(2 * np.pi * r.uniform(80, 0.16 * sr) * t) for _ in range(3))
        w = w + 0.05 * r.standard_normal(n)
        out.append((0.4 * w / np.abs(w).max()).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def scorers(clap_dir, tmp_path_factory):
    """The port's scorer from the CLAP dir itself and from a dir holding it
    as ``clap/``; the JAX scorer."""
    holder = str(tmp_path_factory.mktemp("holder"))
    shutil.copytree(clap_dir, os.path.join(holder, "clap"))
    return (ClapScorer.from_checkpoint(clap_dir, device="cpu"), ClapScorer.from_checkpoint(holder, device="cpu"),
            JaxClapScorer.from_checkpoint(clap_dir))


def test_scorer_matches_jax_in_both_layouts(scorers):
    direct, held, jax_scorer = scorers
    gen = tones(0, (48000, 30000, clap_features.MAX_SAMPLES + 20000))  # the last one is cropped
    ref = tones(1, (40000, 48000, 20000))
    want_emb = np.asarray(jax_scorer.embed_audio(gen))
    want_scores = jax_scorer.clap_scores(gen, "hip hop music")
    want_kad = float(jax_kad(jax_scorer.embed_audio(ref), jnp.asarray(want_emb)))  # JAX's ``kad``, jitted
    for scorer in (direct, held):
        emb = scorer.embed_audio(gen)
        assert emb.shape == (3, 8) and emb.device.type == "cpu"
        np.testing.assert_allclose(emb.numpy(), want_emb, atol=1e-4)
        np.testing.assert_allclose(scorer.clap_scores(gen, "hip hop music"), want_scores, atol=1e-4)
        np.testing.assert_allclose(scorer.kad(ref, gen), want_kad, atol=1e-3)
    np.testing.assert_allclose(direct.embed_text(["hip hop music", "a much longer prompt of rain on a roof"]).numpy(),
                               np.asarray(jax_scorer.embed_text(["hip hop music", "a much longer prompt of rain on a roof"])),
                               atol=1e-4)
    assert np.ptp(want_scores) > 1e-5 and abs(want_kad) > 1e-2
    assert metrics.median_pairwise_distance(direct.embed_audio(gen)).item() > 0.05  # not near the 1e-3 regime


@pytest.mark.parametrize("batch_size", [2, 3])
def test_embed_audio_chunked_equals_unchunked(scorers, batch_size):
    wavs = tones(2, (48000,) * 5)
    one = scorers[0].embed_audio(wavs, batch_size=None)
    torch.testing.assert_close(scorers[0].embed_audio(wavs, batch_size=batch_size), one, rtol=0, atol=1e-6)


def test_score_directories_refuses_empty_inputs(clap_dir, tmp_path):
    (tmp_path / "none").mkdir()
    (tmp_path / "none" / "notes.txt").write_text("x")
    with pytest.raises(ValueError, match="no .wav files"):
        score_directories(clap_dir, str(tmp_path / "none"), device="cpu")
    (tmp_path / "empty").mkdir()
    write_wav(str(tmp_path / "empty" / "a.wav"), np.zeros(0, np.float32), 16000)
    with pytest.raises(ValueError, match="empty wav"):
        score_directories(clap_dir, str(tmp_path / "empty"), device="cpu")
