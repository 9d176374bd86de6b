"""The port's CLAP evaluation at its user surface (``cli score``, ``cli
generate --best-of N --clap DIR``, ``log_validation(scorer=,
ref_audios_16k=)`` and ``cli train --clap-dir``) against the JAX package, fp32
on the CPU, at the tiny geometry of tests/test_torch_port_pipeline.py and
the tiny CLAP directory of tests/test_torch_port_eval.py.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu import cli as jax_cli
from audioldm_tpu.config import LoRAConfig as JaxLoRAConfig
from audioldm_tpu.eval.scoring import ClapScorer as JaxClapScorer
from audioldm_tpu.lora import init_lora as jax_init_lora
from audioldm_tpu.pipeline.generate import init_noise as jax_init_noise
from audioldm_tpu.train.validation import log_validation as jax_log_validation
from audioldm_tpu_torch import cli
from audioldm_tpu_torch import config as tcfg
from audioldm_tpu_torch.ckpt import lora_from_jax
from audioldm_tpu_torch.data.wavio import read_wav, write_wav
from audioldm_tpu_torch.eval.metrics import kernel_audio_distance
from audioldm_tpu_torch.eval.scoring import ClapScorer
from audioldm_tpu_torch.train.validation import log_validation
from test_torch_port_eval import clap_dir, tones  # noqa: F401 (fixture)
from test_torch_port_pipeline import SECONDS, checkpoint, jax_modules, port_modules  # noqa: F401 (fixtures)
from test_torch_port_train_cli import _train, corpus  # noqa: F401 (fixture)
from tests.test_serve import DummyTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool of threads only waits
    for its members, and slows by orders of magnitude when test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_score_matches_jax(clap_dir, tmp_path):  # noqa: F811
    """16 kHz clips (resampled to 48 kHz on the way in) against 48 kHz
    references, one of them over 10 s (cropped)."""
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    gen.mkdir(), ref.mkdir()
    for i, w in enumerate(tones(5, (16000, 12000, 20000), sr=16000)):
        write_wav(str(gen / f"g{i}.wav"), w, 16000)
    for i, w in enumerate(tones(6, (48000, 30000, 500000))):
        write_wav(str(ref / f"r{i}.wav"), w, 48000)
    argv = ["score", "--checkpoint", clap_dir, "--generated", str(gen), "--reference", str(ref),
            "--prompt", "hip hop music", "--output"]
    jax_cli.main(argv + [str(tmp_path / "jax.json")])
    cli.main(argv + [str(tmp_path / "port.json"), "--device", "cpu"])
    want, got = (json.load(open(tmp_path / f"{n}.json")) for n in ("jax", "port"))
    assert got.keys() == want.keys() == {"num_generated", "clap_scores", "clap_score_mean", "num_reference", "kad"}
    assert got["num_generated"] == got["num_reference"] == 3
    np.testing.assert_allclose(got["clap_scores"], want["clap_scores"], atol=1e-4)
    np.testing.assert_allclose(got["clap_score_mean"], want["clap_score_mean"], atol=1e-4)
    np.testing.assert_allclose(got["kad"], want["kad"], atol=1e-3)
    assert np.ptp(got["clap_scores"]) > 1e-5 and np.isfinite(got["kad"])


def test_cli_generate_best_of_keeps_the_clap_highest_candidate(checkpoint, clap_dir, tmp_path, capsys):  # noqa: F811
    """``--best-of 2`` writes, bit for bit, the candidate of the batch-2
    ``generate`` of the same seed whose CLAP score is highest."""
    base = ["generate", "--checkpoint", checkpoint, "--prompt", "hip hop music", "--steps", "2", "--seconds",
            str(SECONDS), "--seed", "5", "--fp32", "--device", "cpu"]
    cli.main(base + ["--batch", "2", "--output", str(tmp_path / "cand.wav")])
    cli.main(base + ["--best-of", "2", "--clap", clap_dir, "--output", str(tmp_path / "best.wav")])
    printed = capsys.readouterr().out
    m = re.search(r"best-of-2: kept candidate (\d) \(clap [0-9.]+; all: \[(.*)\]\)", printed)
    assert m and f"wrote {tmp_path / 'best.wav'}" in printed
    kept, scores = int(m[1]), [float(x) for x in m[2].split(",")]
    assert scores[kept] == max(scores)
    cands = [read_wav(str(tmp_path / f"cand_{i}.wav"))[0] for i in range(2)]
    assert not np.array_equal(cands[0], cands[1])
    np.testing.assert_array_equal(read_wav(str(tmp_path / "best.wav"))[0], cands[kept])
    scorer = ClapScorer.from_checkpoint(clap_dir, device="cpu")
    # the candidates as written (16-bit) against the scores printed to 4 decimals
    np.testing.assert_allclose(scorer.clap_scores(scorer.to_48k(cands, 16000), "hip hop music"), scores, atol=1e-3)


def test_log_validation_scores_match_jax(jax_modules, clap_dir, capsys):  # noqa: F811
    """Both passes against JAX's at the multi-step 2e-3, and their scores.

    The scores are the port's scorer on the port's audio (1e-6), and JAX's
    within the scorers' own bound, 1e-4 (measured 1.2e-7: the passes'
    difference, under 2e-3, barely moves the CLAP embedding of a clip
    repeat-padded to 10 s). KAD here is about 140 (x100 scale: the random
    UNet's clips lie far from the tone references), a difference of terms
    whose fp32 rounding scales with them, so it is held to 2e-4 relative
    (measured 3.1e-5)."""
    jlcfg, lcfg = JaxLoRAConfig(r=2, lora_alpha=4), tcfg.LoRAConfig(r=2, lora_alpha=4.0)
    jl = jax_init_lora(jax.random.PRNGKey(1), jax_modules.unet, jlcfg)
    jl = jax.tree.map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape), jl)
    kw = dict(num_clips=2, num_inference_steps=2, audio_length_in_s=SECONDS, guidance_scale=2.0, seed=5)
    refs = tones(7, (2560, 2560), sr=16000)
    tok = DummyTokenizer()
    want = jax_log_validation(jax_modules, jl, jlcfg, tok, "hip hop music", dtype=jnp.float32,
                              scorer=JaxClapScorer.from_checkpoint(clap_dir), ref_audios_16k=refs, **kw)
    lat, _ = jax_init_noise(jax_modules, jax.random.PRNGKey(5), 2, SECONDS)
    scorer = ClapScorer.from_checkpoint(clap_dir, device="cpu")
    mods, lora = port_modules(jax_modules), lora_from_jax(jax.tree.map(np.asarray, jl))
    got = log_validation(mods, lora, lcfg, tok, "hip hop music", dtype=torch.float32, device="cpu", scorer=scorer,
                         ref_audios_16k=refs, latents=torch.from_numpy(np.array(lat).transpose(0, 3, 1, 2)), **kw)
    keys = ("clap_score", "original_clap_score", "kad_score_lora", "kad_score_original")
    assert set(got) == set(want) == {"audios", "original_audios", *keys}
    for k in ("audios", "original_audios"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-3)
    t = scorer.embed_text(["hip hop music"])
    r = scorer.embed_audio(scorer.to_48k(refs, 16000))
    for score, kad, audio in (("clap_score", "kad_score_lora", "audios"), ("original_clap_score", "kad_score_original",
                                                                            "original_audios")):
        a = scorer.embed_audio(scorer.to_48k(got[audio], 16000))
        np.testing.assert_allclose(got[score], float(((a @ t.T) + 1).mean() / 2), atol=1e-6)
        np.testing.assert_allclose(got[kad], float(kernel_audio_distance(r, a)), atol=1e-6)
        np.testing.assert_allclose(got[score], want[score], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[kad], want[kad], rtol=2e-4)
    assert abs(got["kad_score_lora"] - got["kad_score_original"]) > 1e-3  # the adapters are felt

    # a reference corpus of one clip: the scores, no KAD, a note
    one = log_validation(mods, lora, lcfg, tok, "hip hop music", dtype=torch.float32, device="cpu", scorer=scorer,
                         ref_audios_16k=refs[:1], latents=torch.from_numpy(np.array(lat).transpose(0, 3, 1, 2)), **kw)
    assert set(one) == {"audios", "original_audios", "clap_score", "original_clap_score"}
    assert "validation: skipping KAD (needs >= 2 clips per set, got 1 ref / 2 generated)" in capsys.readouterr().out


def test_cli_train_with_clap_dir_logs_the_four_scores(checkpoint, corpus, clap_dir, tmp_path):  # noqa: F811
    out = str(tmp_path / "out")
    _, state = _train(checkpoint, corpus, out, "--max-steps", "2", "--validate-every", "1", "--val-clips", "2",
                      "--clap-dir", clap_dir)
    assert state.step == 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    keys = ("clap_score", "original_clap_score", "kad_score_lora", "kad_score_original")
    scored = [r for r in recs if "clap_score" in r]
    assert len(scored) == 1 and scored[0]["step"] == 2
    assert all(np.isfinite(scored[0][k]) for k in keys)
    assert all(0.0 <= scored[0][k] <= 1.0 for k in keys[:2])
