"""The port's tail (audioldm_tpu_torch/ops/invert.py, ``data.wavio.slice_wav``,
utils/profiling.py, utils/fastinit.py, utils/tools.py and ``cli slice``,
``export-dataset``, ``push-dataset``) against the JAX package's functions
and commands, on the CPU.

Griffin-Lim's phase init comes from ``jax.random`` in the JAX package and
from a ``torch.Generator`` in the port; the parity cases hand the port the
JAX phase. The dataset pair runs offline: ``push-dataset --save`` writes a
``save_to_disk`` directory, which ``datasets.load_dataset`` (what both
packages' ``export-dataset`` call) refuses, so ``export-dataset`` reads a
directory holding ``train.parquet``; the refusal is pinned as the
reference's behaviour.
"""

import contextlib
import hashlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu import cli as jax_cli
from audioldm_tpu.data.wavio import slice_wav as jax_slice_wav
from audioldm_tpu.ops import invert as jax_invert
from audioldm_tpu.utils import tools as jax_tools
from audioldm_tpu_torch import cli
from audioldm_tpu_torch.data.wavio import read_wav, slice_wav, write_wav
from audioldm_tpu_torch.ops import invert
from audioldm_tpu_torch.utils import fastinit, profiling, tools, trace_context


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.4).astype(np.float32)


def _sine(n, f=440.0, sr=16000):
    return (0.5 * np.sin(2 * np.pi * f * np.arange(n) / sr)).astype(np.float32)


def test_stft_and_istft_match_jax():
    """The complex STFT (2e-5 of its 1.0-scale values) and the inverse of a
    JAX spectrum (1e-5), at a batch of 2; the round trip of a hop-aligned
    signal reconstructs it to 1e-4 (tests/test_invert.py)."""
    x = np.stack([_noise(4000, 1), _noise(4000, 2)])
    ref = np.asarray(jax_invert.stft_complex(jnp.asarray(x), 512, 128, 512))
    spec = invert.stft_complex(torch.from_numpy(x), 512, 128, 512)
    assert spec.shape == ref.shape == (2, 32, 257)
    np.testing.assert_allclose(spec.numpy(), ref, atol=2e-5)
    back = invert.istft(torch.from_numpy(ref.copy()), 512, 128, 512).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_invert.istft(jnp.asarray(ref), 512, 128, 512)), atol=1e-5)
    n = 7936  # hop-aligned: center-pad 256 x 2, 63 frames
    y = _noise(n, 3)
    rt = invert.istft(invert.stft_complex(torch.from_numpy(y)[None], 512, 128, 512), 512, 128, 512, length=n)[0]
    np.testing.assert_allclose(rt.numpy(), y, atol=1e-4)
    np.testing.assert_array_equal(invert.window_sumsquare(63, 128, 512, 512), jax_invert.window_sumsquare(63, 128, 512, 512))


def test_griffin_lim_matches_jax_and_recovers_a_sine():
    """From the JAX phase init, 8 iterations equal the JAX function's (1e-4
    of a peak near 1.5); from a generator, 40 iterations beat 5 and reach the
    vanilla plateau under 0.2 of the spectrum (tests/test_invert.py)."""
    x = _sine(8000)
    mag_j = jnp.abs(jax_invert.stft_complex(jnp.asarray(x)[None], 512, 128, 512))
    key = jax.random.PRNGKey(0)
    phase = np.array(jax.random.uniform(key, mag_j.shape, jnp.float32, -np.pi, np.pi))
    ref = np.asarray(jax_invert.griffin_lim(mag_j, key, 8, 512, 128, 512))
    mag = torch.from_numpy(np.asarray(mag_j).copy())
    out = invert.griffin_lim(mag, None, 8, 512, 128, 512, phase=torch.from_numpy(phase))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)

    def spectral_err(n_iters):
        rec = invert.griffin_lim(mag, torch.Generator().manual_seed(0), n_iters, 512, 128, 512)
        m = invert.stft_complex(rec, 512, 128, 512).abs()[:, : mag.shape[1]]
        return float(torch.linalg.vector_norm(m - mag[:, : m.shape[1]]) / torch.linalg.vector_norm(mag))

    e5, e40 = spectral_err(5), spectral_err(40)
    assert e40 < e5 and e40 < 0.2


def test_inv_mel_spec_matches_jax():
    """A 0.32 s log-mel of a sine back to a waveform: the JAX function's
    output from the same phase init to 1e-4, finite, with energy."""
    from audioldm_tpu.config import MelConfig
    from audioldm_tpu.ops import log_mel_spectrogram

    cfg = MelConfig(duration=0.32)
    logmel = log_mel_spectrogram(jnp.asarray(_sine(cfg.num_samples, 440.0) * 0.8)[None], cfg)
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jax_invert.inv_mel_spec(logmel, key, n_iters=16))
    shape = logmel.shape[:-1] + (513,)
    phase = torch.from_numpy(np.asarray(jax.random.uniform(key, shape, jnp.float32, -np.pi, np.pi)).copy())
    out = invert.inv_mel_spec(torch.from_numpy(np.asarray(logmel).copy()), n_iters=16, phase=phase).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all() and out.std() > 1e-3
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _wav(path, seconds=2.5, sr=16000):
    write_wav(str(path), _sine(int(seconds * sr), sr=sr) * 0.9, sr)


def test_slice_wav_writes_the_jax_files(tmp_path):
    """The same segment files, byte for byte; the short tail dropped."""
    _wav(tmp_path / "clip.wav")
    ours = slice_wav(str(tmp_path / "clip.wav"), str(tmp_path / "port"), 1.0)
    theirs = jax_slice_wav(str(tmp_path / "clip.wav"), str(tmp_path / "jax"), 1.0)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] == ["clip_0000.wav", "clip_0001.wav"]
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_cli_slice_matches_the_jax_command(tmp_path):
    """``cli slice`` on a folder: the JAX command's files and printed line."""
    src = tmp_path / "src"
    src.mkdir()
    _wav(src / "a.wav", 2.5)
    _wav(src / "b.wav", 1.2)
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            main(["slice", "--input", str(src), "--output", str(tmp_path / name), "--seconds", "1.0"])
        outs[name] = printed.getvalue().replace(str(tmp_path / name), "OUT")
    assert outs["port"] == outs["jax"] == "wrote 3 segments to OUT\n"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def _corpus(folder):
    folder.mkdir()
    for i, (sec, sr) in enumerate(((0.5, 16000), (0.3, 22050))):
        write_wav(str(folder / f"clip{i}.wav"), _noise(int(sec * sr), i) * 0.5, sr)
        (folder / f"clip{i}.txt").write_text(f"caption number {i}")


def _rows(ds):
    return [(np.asarray(r["audio"]["array"], np.float32), int(r["audio"]["sampling_rate"]), r["caption"]) for r in ds]


def test_push_dataset_save_matches_the_jax_command(tmp_path):
    """``push-dataset --save``: the JAX command's printed line, and rows
    equal to its dataset's (audio arrays, rates, captions)."""
    from datasets import load_from_disk

    _corpus(tmp_path / "corpus")
    printed = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["push-dataset", "--input", str(tmp_path / "corpus"), "--save", str(tmp_path / name)])
        printed[name] = buf.getvalue().replace(str(tmp_path / name), "DIR")
    assert printed["port"] == printed["jax"] == "saved dataset to DIR\n"
    ours, theirs = (_rows(load_from_disk(str(tmp_path / n))) for n in ("port", "jax"))
    assert len(ours) == len(theirs) == 2
    for (a, sr_a, cap_a), (b, sr_b, cap_b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert (sr_a, cap_a) == (sr_b, cap_b)


def test_export_dataset_from_parquet_matches_the_jax_command(tmp_path):
    """``export-dataset`` from a directory holding ``train.parquet`` (what
    ``load_dataset`` reads offline): the JAX command's wav and txt files,
    byte for byte, and its printed line; ``--limit`` stops early."""
    from datasets import Dataset

    _corpus(tmp_path / "corpus")
    from audioldm_tpu_torch.data.dataset import AudioCaptionDataset

    ds = AudioCaptionDataset(str(tmp_path / "corpus"))
    raw = [ds.get_raw(i) for i in range(len(ds))]
    (tmp_path / "pq").mkdir()
    Dataset.from_dict({"audio": [{"array": w, "sampling_rate": sr} for w, sr, _ in raw],
                       "caption": [c for _, _, c in raw]}).to_parquet(str(tmp_path / "pq" / "train.parquet"))
    printed = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["export-dataset", "--dataset", str(tmp_path / "pq"), "--output", str(tmp_path / name)])
        printed[name] = buf.getvalue().replace(str(tmp_path / name), "OUT")
    assert printed["port"] == printed["jax"] == "exported 2 items to OUT\n"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "000000.txt", "000000.wav", "000001.txt", "000001.wav"]
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    wav, sr = read_wav(str(tmp_path / "port" / "000001.wav"))
    assert sr == 22050 and (tmp_path / "port" / "000001.txt").read_text() == "caption number 1"
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export-dataset", "--dataset", str(tmp_path / "pq"), "--output", str(tmp_path / "one"), "--limit", "1"])
    assert sorted(os.listdir(tmp_path / "one")) == ["000000.txt", "000000.wav"]


def test_load_dataset_refuses_a_save_to_disk_directory(tmp_path):
    """The reference's behaviour, pinned: ``export-dataset`` reads with
    ``load_dataset``, which refuses what ``push-dataset --save`` wrote
    (``save_to_disk``); both packages raise alike."""
    _corpus(tmp_path / "corpus")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["push-dataset", "--input", str(tmp_path / "corpus"), "--save", str(tmp_path / "saved")])
    for main in (cli.main, jax_cli.main):
        with pytest.raises(Exception, match="load_from_disk"):
            main(["export-dataset", "--dataset", str(tmp_path / "saved"), "--output", str(tmp_path / "out")])


def test_tools_match_jax(tmp_path, monkeypatch):
    """Every helper of ``utils/tools.py`` against the JAX one: the dataset
    json, checkpoint-step discovery, MD5 and its check, nested lookup, and
    the downloader offline through ``file://`` (fetch, MD5-checked cache,
    a corrupt file fetched again, a mismatch, an unknown name, a missing
    file's error)."""
    prompts = ["a dog", "rain on a roof"]
    assert tools.build_dataset_json_from_list(prompts, str(tmp_path / "p.json")) == \
        jax_tools.build_dataset_json_from_list(prompts)
    assert json.loads((tmp_path / "p.json").read_text())["data"][1]["caption"] == "rain on a roof"
    for name in ("checkpoint-3", "checkpoint-12", "7", "other"):
        (tmp_path / "ck" / name).mkdir(parents=True)
    assert tools.get_restore_step(str(tmp_path / "ck")) == jax_tools.get_restore_step(str(tmp_path / "ck")) == 12
    assert tools.get_restore_step(str(tmp_path / "none")) is None
    src = tmp_path / "src.bin"
    src.write_bytes(b"checkpoint-bytes")
    md5 = hashlib.md5(b"checkpoint-bytes").hexdigest()
    assert tools.md5_file(str(src)) == jax_tools.md5_file(str(src)) == md5
    assert tools.verify_checkpoint(str(src), md5) and not tools.verify_checkpoint(str(src), "0" * 32)
    cfg = {"train": {"lr": 1e-5, "steps": [10, 20]}, "obj": type("O", (), {"x": 3})()}
    for path, default in (("train/lr", None), ("train/steps/1", None), ("obj/x", None), ("train/nope", 5), ("train/steps/9", 0)):
        assert tools.retrieve(cfg, path, default) == jax_tools.retrieve(cfg, path, default)
    assert (tools.URL_MAP, tools.CKPT_MAP, tools.MD5_MAP) == (jax_tools.URL_MAP, jax_tools.CKPT_MAP, jax_tools.MD5_MAP)

    url = "file://" + str(src)
    assert open(tools.download(url, str(tmp_path / "dl" / "a.bin")), "rb").read() == b"checkpoint-bytes"
    for table, value in ((tools.URL_MAP, url), (tools.CKPT_MAP, "tiny.bin"), (tools.MD5_MAP, md5)):
        monkeypatch.setitem(table, "tiny", value)
    root = str(tmp_path / "root")
    p = tools.get_ckpt_path("tiny", root, check=True)
    assert open(p, "rb").read() == b"checkpoint-bytes"
    open(p, "wb").write(b"garbage")
    assert open(tools.get_ckpt_path("tiny", root, check=True), "rb").read() == b"checkpoint-bytes"
    monkeypatch.setitem(tools.MD5_MAP, "tiny", "0" * 32)
    open(p, "wb").write(b"garbage")
    with pytest.raises(ValueError, match="md5 mismatch"):
        tools.get_ckpt_path("tiny", root, check=True)
    with pytest.raises(KeyError):
        tools.get_ckpt_path("nope", root)
    with pytest.raises(RuntimeError, match="could not download"):
        tools.download("file:///nonexistent/x.bin", str(tmp_path / "x.bin"))


def test_random_params_like_keeps_shapes_and_dtypes():
    """One fused draw over a model's state dict: shapes and dtypes kept
    (bf16 with ``dtype``), N(0, 0.02) values, the vocoder's normalisation
    statistics at their identity values, the same draw from the same seed."""
    from audioldm_tpu_torch import config as tcfg
    from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan

    cfg = tcfg.VocoderConfig(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4))
    voc = SpeechT5HifiGan(cfg)
    shapes = fastinit.shapes_of(voc)
    fastinit.random_params_like(voc, torch.Generator().manual_seed(0))
    assert fastinit.shapes_of(voc) == shapes
    sd = voc.state_dict()
    assert torch.equal(sd["mean"], torch.zeros_like(sd["mean"])) and torch.equal(sd["scale"], torch.ones_like(sd["scale"]))
    w = sd["conv_pre.weight"].float()
    assert 0.01 < float(w.std()) < 0.03 and abs(float(w.mean())) < 0.01
    again = SpeechT5HifiGan(cfg)
    fastinit.random_params_like(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(sd.values(), again.state_dict().values()))
    fastinit.random_params_like(again, torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    assert {v[1] for v in fastinit.shapes_of(again).values()} == {torch.bfloat16}
    assert {k: v[0] for k, v in fastinit.shapes_of(again).items()} == {k: v[0] for k, v in shapes.items()}


def test_trace_context_writes_a_trace_and_annotates(tmp_path):
    """``trace_context`` writes ``trace.json`` holding the program's spans
    opened in its region, nested as they ran, and its counters; spans are
    off again after it; with no directory it is a no-op."""
    with trace_context(None) as prof:
        assert prof is None
    with trace_context(str(tmp_path / "tr")):
        with profiling.span("port_region", key=3):
            with profiling.span("port_inner"):
                torch.ones(8) @ torch.ones(8)
        profiling.count("port_count", 2)
    assert not profiling.enabled()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    spans = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "program_span"}
    assert set(spans) == {"port_region", "port_inner"}
    outer, inner = spans["port_region"], spans["port_inner"]
    assert inner["args"]["parent"] == outer["args"]["id"] and inner["args"]["key"] == outer["args"]["key"] == 3
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert trace["programCounters"] == {"port_count": 2} and trace["programSpansDropped"] == 0
