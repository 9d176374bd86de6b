"""The port's data layer (audioldm_tpu_torch/data, ops/kaldi.py, the device
``resample`` and ``get_mel_from_wav``) against the JAX package, case for case
with tests/test_data.py, test_kaldi_fbank.py, test_native.py and
test_plugins_meta.py, on the CPU at the small geometry of tests/test_data.py
(``MelConfig(duration=0.32)``: 5120 samples, 32 frames).

Host-side randomness is a seeded numpy Generator in both packages, so the
same seed gives the same segments, permutations, SpecAugment masks and
waveforms, bit for bit; the device front end (STFT, log-mel) agrees at 1e-4,
the port's NCHW log-mel transposed to the JAX package's NHWC.
"""

import os
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audioldm_tpu.config import MelConfig as JaxMelConfig
from audioldm_tpu.data import dataset as jds
from audioldm_tpu.data import native as jnative
from audioldm_tpu.data.tokenizer import RobertaBPETokenizer as JaxTokenizer
from audioldm_tpu.ops import kaldi as jkaldi
from audioldm_tpu.ops import mel as jmel
from audioldm_tpu.ops.resample import resample as jax_resample
from audioldm_tpu_torch.config import MelConfig
from audioldm_tpu_torch.data import AudioCaptionDataset, DataPipeline, RobertaBPETokenizer, native
from audioldm_tpu_torch.data import dataset as tds
from audioldm_tpu_torch.data import plugins_meta as tpm
from audioldm_tpu_torch.data.wavio import read_wav, write_wav
from audioldm_tpu_torch.ops import kaldi as tkaldi
from audioldm_tpu_torch.ops import mel as tmel
from audioldm_tpu_torch.ops.resample import resample, resample_np
from test_data import bpe_files  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL, JSMALL = MelConfig(duration=0.32), JaxMelConfig(duration=0.32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny sizes a pool of threads only waits
    for its members, and slows by orders of magnitude when test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toks(bpe_files):  # noqa: F811
    vocab, merges = bpe_files
    return JaxTokenizer.from_files(vocab, merges), RobertaBPETokenizer.from_files(vocab, merges)


def _clip(rng, n, scale=0.4):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _items(n=5, seed=0):
    rng = np.random.default_rng(seed)
    srs = (24000, 16000, 22050, 16000, 44100)
    return [{"wav": _clip(rng, int(srs[i % 5] * (0.2 + 0.15 * i))), "sr": srs[i % 5],
             "caption": f"clip {i} " + "hip hop " * i, "metadata": {"phonemes": "ab" * (i + 1)}} for i in range(n)]


def _pipes(toks, items, **kw):
    jtok, ttok = toks
    return (jds.DataPipeline(jds.AudioCaptionDataset(items), jtok, JSMALL, max_text_length=kw.pop("max_text_length", 16), **kw),
            DataPipeline(AudioCaptionDataset(items), ttok, SMALL, max_text_length=16, device="cpu", **kw))


def _same_batch(jb, tb, mel_tol=1e-4):
    """A JAX batch against the port's: host fields equal, device fields at ``mel_tol``."""
    np.testing.assert_array_equal(tb["waveform"], jb["waveform"])
    np.testing.assert_array_equal(tb["random_start"], jb["random_start"])
    np.testing.assert_array_equal(tb["input_ids"].numpy(), np.asarray(jb["input_ids"]))
    np.testing.assert_array_equal(tb["attention_mask"].numpy(), np.asarray(jb["attention_mask"]))
    assert tb["log_mel_spec"].shape[1] == 1  # NCHW
    np.testing.assert_allclose(tb["log_mel_spec"].numpy().transpose(0, 2, 3, 1), np.asarray(jb["log_mel_spec"]), atol=mel_tol)
    np.testing.assert_allclose(tb["stft"].numpy(), np.asarray(jb["stft"]), atol=mel_tol)
    assert (tb["duration"], tb["sampling_rate"]) == (jb["duration"], jb["sampling_rate"])


# -- plugins -----------------------------------------------------------------

_META = {
    "get_vits_phoneme_ids": {"phonemes": "hɛloʊ wɜːld"},
    "get_vits_phoneme_ids_no_padding": {"phonemes": "ab☃"},
    "extract_vits_phoneme_and_flant5_text": {"phonemes": "ab"},
    "extract_fs2_phoneme_and_flant5_text": {"phoneme": ["K", "AA1", "sp", "HH"]},
    "extract_fs2_phoneme_g2p_en_feature": {"phoneme": ["K", "AA1", "not-a-phone", "HH"]},
    "extract_phoneme_g2p_en_feature": {"phoneme": [" ", "AA", "ZH", "B"]},
    "extract_drum_beat": {"sample_rate": 16000, "beat": [100, 1300, 2600, 9000], "downbeat": [2600]},
}
# the two that resample on the way (the device resample, float64 in the port, fp32 in XLA) and then take a
# log; every other plugin is numpy on the same numbers in both packages and must agree exactly
_RESAMPLING = {"waveform_rs_48k": 1e-5, "extract_kaldi_fbank_feature_32k": 2e-3}


@pytest.mark.parametrize("name", sorted(jds.PLUGINS))
def test_every_plugin_matches_jax(name):
    rng = np.random.default_rng(1)
    wav = _clip(rng, SMALL.num_samples, 0.3)
    mel, stft = (np.asarray(x[0]) for x in jmel.log_mel_spectrogram(jnp.asarray(wav)[None], JSMALL, return_stft=True))
    item = {"waveform": wav, "log_mel_spec": mel, "stft": stft, "metadata": _META.get(name, {}), "random_start": 1000,
            "duration": SMALL.duration, "sampling_rate": SMALL.sampling_rate}
    assert set(tds.PLUGINS) == set(jds.PLUGINS)
    want, got = jds.PLUGINS[name](dict(item), JSMALL), tds.PLUGINS[name](dict(item), SMALL)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        elif name in _RESAMPLING:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], atol=_RESAMPLING[name], rtol=0)
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_plugin_tables_are_the_jax_tables():
    from audioldm_tpu.data import plugins_meta as jpm

    assert tpm.VITS_SYMBOLS == jpm.VITS_SYMBOLS and tpm._VITS_SYMBOL_TO_ID == jpm._VITS_SYMBOL_TO_ID
    assert tpm._FS2_LOOKUP == jpm._FS2_LOOKUP and tpm._G2P_LOOKUP == jpm._G2P_LOOKUP
    with pytest.raises(KeyError):  # strict lookup, as in JAX
        tds.PLUGINS["get_vits_phoneme_ids"]({"metadata": {"phonemes": "☃"}}, SMALL)
    with pytest.raises(AssertionError):
        tds.PLUGINS["extract_vits_phoneme_and_flant5_text"]({"metadata": {"phoneme": ["K"]}}, SMALL)


# -- kaldi, mel, resample ----------------------------------------------------


@pytest.mark.parametrize("sf", [16000, 32000])
def test_kaldi_fbank_matches_jax(sf):
    wav = _clip(np.random.default_rng(2), sf, 0.3)
    np.testing.assert_array_equal(tkaldi.kaldi_fbank(wav, float(sf)), jkaldi.kaldi_fbank(wav, float(sf)))
    np.testing.assert_array_equal(tkaldi.mel_banks(128, 512, float(sf)), jkaldi.mel_banks(128, 512, float(sf)))
    assert tkaldi.kaldi_fbank(np.zeros(100, np.float32)).shape == (0, 128)


@pytest.mark.parametrize("cfg,jcfg", [(SMALL, JSMALL), (MelConfig(duration=0.16, n_mel=8), JaxMelConfig(duration=0.16, n_mel=8))])
def test_get_mel_from_wav_matches_jax(cfg, jcfg):
    wav = _clip(np.random.default_rng(3), 2 * cfg.num_samples, 0.3).reshape(2, -1)
    got = tmel.get_mel_from_wav(torch.from_numpy(wav), cfg)
    want = jmel.get_mel_from_wav(jnp.asarray(wav), jcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)
    x = torch.linspace(-3, 2, 11)
    np.testing.assert_allclose(tmel.dynamic_range_decompression(x, 2.0).numpy(),
                               np.asarray(jmel.dynamic_range_decompression(jnp.asarray(x.numpy()), 2.0)), rtol=1e-6)


@pytest.mark.parametrize("orig,new", [(24000, 16000), (16000, 48000), (22050, 16000), (44100, 16000)])
def test_device_resample_matches_jax(orig, new):
    x = _clip(np.random.default_rng(4), 2 * orig // 5, 0.4).reshape(2, -1)
    want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    got = resample(torch.from_numpy(x), orig, new)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), resample_np(x, orig, new), atol=1e-5, rtol=0)
    assert resample(torch.from_numpy(x), orig, orig) is not None


# -- the native library ------------------------------------------------------


def test_native_build_matches_the_jax_loader_and_writes_nothing_under_cpp(tmp_path, monkeypatch):
    if not jnative.available():
        pytest.skip("g++ unavailable; the JAX loader has no library to compare against")
    cpp = os.path.join(REPO, "cpp")
    before = {n: os.stat(os.path.join(cpp, n)).st_mtime_ns for n in os.listdir(cpp)}
    monkeypatch.setattr(native, "SO", str(tmp_path / "_build" / "libaudioprep.so"))
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available() and os.path.exists(native.SO)  # built afresh into the port's build dir
    assert {n: os.stat(os.path.join(cpp, n)).st_mtime_ns for n in os.listdir(cpp)} == before
    assert native.SO.endswith(os.path.join("_build", "libaudioprep.so"))

    rng = np.random.default_rng(5)
    x = _clip(rng, 24000)
    for orig, new in ((24000, 16000), (16000, 48000), (22050, 16000)):
        np.testing.assert_array_equal(native.resample_native(x, orig, new), jnative.resample_native(x, orig, new))
    y = (rng.standard_normal(5000) * 3 + 0.7).astype(np.float32)
    np.testing.assert_array_equal(native.normalize_native(y), jnative.normalize_native(y))
    assert native.peak_abs(y) == jnative.peak_abs(y)
    raw = rng.integers(-32768, 32768, size=4097).astype("<i2").tobytes()
    for ch in (1, 2):
        np.testing.assert_array_equal(native.decode_pcm16(raw, ch), jnative.decode_pcm16(raw, ch))


def test_native_numpy_paths_match_the_library(monkeypatch):
    rng = np.random.default_rng(6)
    x, y = _clip(rng, 22050), (rng.standard_normal(3000) * 2 + 0.3).astype(np.float32)
    raw = rng.integers(-32768, 32768, size=4096).astype("<i2").tobytes()
    lib = [native.resample_native(x, 22050, 16000), native.normalize_native(y), native.peak_abs(y)] + \
          [native.decode_pcm16(raw, ch) for ch in (1, 2)]
    monkeypatch.setattr(native, "_LIB", False)  # as without g++
    assert not native.available()
    plain = [native.resample_native(x, 22050, 16000), native.normalize_native(y), native.peak_abs(y)] + \
            [native.decode_pcm16(raw, ch) for ch in (1, 2)]
    np.testing.assert_allclose(plain[0], lib[0], atol=1e-5)
    np.testing.assert_allclose(plain[1], lib[1], atol=1e-6)
    assert abs(plain[2] - lib[2]) < 1e-7
    np.testing.assert_array_equal(plain[3], lib[3])
    np.testing.assert_allclose(plain[4], lib[4], atol=1e-7)


# -- wav input ---------------------------------------------------------------


def test_wav_io_matches_jax(tmp_path):
    from audioldm_tpu.data.wavio import read_wav as jax_read_wav

    rng = np.random.default_rng(7)
    x = rng.uniform(-0.9, 0.9, 4001).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), x, 22050)
    got, want = read_wav(str(tmp_path / "a.wav")), jax_read_wav(str(tmp_path / "a.wav"))
    assert got[1] == want[1] == 22050
    np.testing.assert_array_equal(got[0], want[0])
    # stereo PCM16 and 24-bit PCM, written by hand
    for bits, data in ((16, rng.integers(-32768, 32768, 400).astype("<i2").tobytes()), (24, bytes(rng.integers(0, 256, 600).astype(np.uint8)))):
        ch = 2
        fmt = struct.pack("<HHIIHH", 1, ch, 16000, 16000 * ch * bits // 8, ch * bits // 8, bits)
        body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
        p = tmp_path / f"s{bits}.wav"
        p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
        np.testing.assert_array_equal(read_wav(str(p))[0], jax_read_wav(str(p))[0])


def test_read_wav_rejects_compressed_formats(tmp_path):
    data = bytes(range(64))
    for fmt_code in (6, 7):  # a-law, mu-law: 8 bits, not integer PCM
        payload = struct.pack("<HHIIHH", fmt_code, 1, 8000, 8000, 1, 8)
        riff = (b"RIFF" + struct.pack("<I", 4 + 8 + len(payload) + 8 + len(data)) + b"WAVE" + b"fmt "
                + struct.pack("<I", len(payload)) + payload + b"data" + struct.pack("<I", len(data)) + data)
        p = tmp_path / f"fmt{fmt_code}.wav"
        p.write_bytes(riff)
        with pytest.raises(ValueError, match="unsupported wav"):
            read_wav(str(p))


# -- datasets ----------------------------------------------------------------


def _same_dataset(jd, td):
    assert len(td) == len(jd)
    for i in range(len(jd)):
        (tw, tsr, tc), (jw, jsr, jc) = td.get_raw(i), jd.get_raw(i)
        np.testing.assert_array_equal(tw, jw)
        assert (tsr, tc) == (jsr, jc)
        assert td.get_metadata(i) == jd.get_metadata(i)


def test_dataset_over_a_folder_matches_jax(tmp_path):
    import json

    rng = np.random.default_rng(8)
    for i in range(3):
        write_wav(str(tmp_path / f"c{i}.wav"), _clip(rng, 3000 + 500 * i, 0.2), 16000 + 8000 * i)
        (tmp_path / f"c{i}.txt").write_text(f"caption {i}\n")
    (tmp_path / "c1.json").write_text(json.dumps({"phonemes": "ab", "beat": [1, 2]}))
    (tmp_path / "notes.md").write_text("not a clip")
    _same_dataset(jds.AudioCaptionDataset(str(tmp_path)), AudioCaptionDataset(str(tmp_path)))


def test_dataset_over_a_list_matches_jax(tmp_path):
    items = _items(4)
    write_wav(str(tmp_path / "p.wav"), _clip(np.random.default_rng(9), 2000, 0.2), 16000)
    items.append({"path": str(tmp_path / "p.wav"), "caption": "from a path"})
    _same_dataset(jds.AudioCaptionDataset(items), AudioCaptionDataset(items))
    with pytest.raises(ValueError, match="unsupported"):
        AudioCaptionDataset(3)


def test_dataset_over_a_hf_dataset_matches_jax():
    import datasets

    rng = np.random.default_rng(10)
    src = datasets.Dataset.from_dict({
        "audio": [{"array": _clip(rng, 3000 + 100 * i, 0.3).tolist(), "sampling_rate": 16000} for i in range(3)],
        "caption": [f"clip {i}" for i in range(3)],
        "metadata": [{"k": i} for i in range(3)],
    })
    _same_dataset(jds.AudioCaptionDataset(src), AudioCaptionDataset(src))


def test_dataset_is_lazy_and_the_hf_row_is_kept(tmp_path, monkeypatch):
    from test_data import _FakeHF

    rng = np.random.default_rng(11)
    for i in range(4):
        write_wav(str(tmp_path / f"c{i}.wav"), _clip(rng, 3000, 0.2), 16000)
    calls = {"n": 0}
    real = tds.read_wav
    monkeypatch.setattr(tds, "read_wav", lambda p: calls.__setitem__("n", calls["n"] + 1) or real(p))
    ds = AudioCaptionDataset(str(tmp_path))
    assert calls["n"] == 0 and len(ds) == 4
    ds.get_raw(2)
    assert calls["n"] == 1
    src = _FakeHF(6, rng)
    hf = AudioCaptionDataset(src)
    assert src.accesses == 0 and len(hf) == 6
    assert hf.get_raw(3)[2] == "clip 3" and hf.get_metadata(3) == {"k": 3} and src.accesses == 1
    hf.get_raw(0)
    assert src.accesses == 2


# -- host helpers ------------------------------------------------------------


def test_segments_trim_labels_and_masks_match_jax():
    wav = np.zeros(10000, np.float32)
    wav[8000:9000] = 0.5
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(20):
        (ts, tstart), (js, jstart) = tds.random_segment(wav, 1000, r1), jds.random_segment(wav, 1000, r2)
        assert tstart == jstart
        np.testing.assert_array_equal(ts, js)
    short = np.ones(10, np.float32)
    assert tds.random_segment(short, 100, r1)[1] == 0
    w2 = np.concatenate([np.zeros(3000), np.full(2000, 0.3), np.zeros(3000)]).astype(np.float32)
    np.testing.assert_array_equal(tds.trim_silence(w2), jds.trim_silence(w2))
    np.testing.assert_array_equal(tds.trim_silence(np.zeros(10, np.float32)), np.zeros(10, np.float32))
    idx = {"drums": 0, "bass": 3, "piano": 5}
    np.testing.assert_array_equal(tds.label_vector("drums, bass, kazoo", idx, 8), jds.label_vector("drums, bass, kazoo", idx, 8))
    mel = np.random.default_rng(1).standard_normal((8, 32, 64)).astype(np.float32)
    for tfn, jfn, m in ((tds.frequency_masking, jds.frequency_masking, 16), (tds.time_masking, jds.time_masking, 8)):
        r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
        got, want = tfn(torch.from_numpy(mel), m, r1), np.asarray(jfn(jnp.asarray(mel), m, r2))
        np.testing.assert_array_equal(got.numpy(), want)
        assert r1.random() == r2.random()  # the same number of draws
        assert len({tuple(np.where((got[b] == 0).all(dim=0 if m == 16 else 1).numpy())[0]) for b in range(8)}) > 1


# -- the pipeline ------------------------------------------------------------


@pytest.mark.parametrize("spec_augment", [False, True])
def test_make_batch_matches_jax(toks, spec_augment):
    kw = dict(freqm=16, timem=8) if spec_augment else {}
    jp, tp = _pipes(toks, _items(), **kw)
    r1, r2 = np.random.default_rng(12), np.random.default_rng(12)
    for idx in ([0, 1, 2], [4, 3]):
        jb, tb = jp.make_batch(idx, r1), tp.make_batch(idx, r2)
        _same_batch(jb, tb)
        assert tb["log_mel_spec"].shape == (len(idx), 1, 32, 64) and tb["input_ids"].shape == (len(idx), 16)
        assert np.max(np.abs(tb["waveform"])) <= 0.5 + 1e-6
    assert r1.random() == r2.random()
    if spec_augment:
        mel = tb["log_mel_spec"][:, 0]
        assert len({tuple(np.where((mel[b] == 0).all(dim=0).numpy())[0]) for b in range(2)}) > 1


def test_make_batch_with_add_ons_matches_jax(toks):
    add_ons = ("extract_vits_phoneme_and_flant5_text", "extract_kaldi_fbank_feature", "extract_drum_beat")
    items = _items(4)
    for it in items:
        it["metadata"] = {**it["metadata"], "sample_rate": it["sr"], "beat": [10, 3000, 6000], "downbeat": [3000]}
    items[1]["metadata"].pop("phonemes")  # a caption item beside the TTS items
    jp, tp = _pipes(toks, items, add_ons=add_ons)
    jb, tb = jp.make_batch([0, 1, 2], np.random.default_rng(13)), tp.make_batch([0, 1, 2], np.random.default_rng(13))
    _same_batch(jb, tb)
    assert tb["text"] == jb["text"] and tb["text"][1] == items[1]["caption"] and tb["text"][0] == ""
    for k in ("phoneme_idx", "ta_kaldi_fbank", "cond_beat_downbeat"):
        assert isinstance(tb[k], np.ndarray)
        np.testing.assert_array_equal(tb[k], jb[k])
    assert tb["cond_beat_downbeat"].shape == (3, 8, 16) and tb["cond_beat_downbeat"].any()
    no = tp.make_batch([0, 1], np.random.default_rng(13), with_plugins=False)
    assert "phoneme_idx" not in no


def test_make_batch_over_a_hf_source_decodes_each_row_once(toks):
    from test_data import _FakeHF

    src = _FakeHF(3, np.random.default_rng(14))
    pipe = DataPipeline(AudioCaptionDataset(src), toks[1], SMALL, add_ons=("calculate_relative_bandwidth",),
                        max_text_length=8, device="cpu")
    batch = pipe.make_batch([0, 2], np.random.default_rng(0))
    assert batch["freq_energy_percentile"].shape == (2, 2) and src.accesses == 2


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_match_jax(toks, prefetch):
    jp, tp = _pipes(toks, _items(5), max_text_length=16)
    seen = {"jax": [], "port": []}
    for name, p in (("jax", jp), ("port", tp)):
        real = p.make_batch
        p.make_batch = lambda idx, rng, _r=real, _n=name, **kw: seen[_n].append([int(i) for i in idx]) or _r(idx, rng, **kw)
    jbs = list(jp.batches(2, np.random.default_rng(15), epochs=2))
    tbs = list(tp.batches(2, np.random.default_rng(15), epochs=2, prefetch=prefetch))
    assert seen["port"] == seen["jax"] and len(tbs) == len(jbs) == 4  # drop_last: 2 a epoch of 5
    for jb, tb in zip(jbs, tbs):
        _same_batch(jb, tb)
    last = list(tp.batches(2, np.random.default_rng(15), shuffle=False, drop_last=False, epochs=1, prefetch=prefetch))
    assert [b["waveform"].shape[0] for b in last] == [2, 2, 1]


def test_impossible_and_empty_datasets_raise(toks):
    one = DataPipeline(AudioCaptionDataset(_items(1)), toks[1], SMALL, max_text_length=8, device="cpu")
    with pytest.raises(ValueError, match="no full batch"):
        next(iter(one.batches(8, np.random.default_rng(0))))
    empty = DataPipeline(AudioCaptionDataset([]), toks[1], SMALL, max_text_length=8, device="cpu")
    for prefetch in (0, 2):
        with pytest.raises(ValueError, match="0 items"):
            next(iter(empty.batches(2, np.random.default_rng(0), drop_last=False, prefetch=prefetch)))


def test_abandoned_prefetch_iterator_stops_its_worker(toks):
    pipe = DataPipeline(AudioCaptionDataset(_items(6)), toks[1], SMALL, max_text_length=8, device="cpu")
    before = threading.active_count()
    it = pipe.batches(1, np.random.default_rng(0), epochs=None, prefetch=2)
    next(it)
    it.close()
    deadline = time.monotonic() + 10.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch worker leaked"


def test_worker_exception_reaches_the_consumer(toks):
    class Broken(AudioCaptionDataset):
        def get_raw(self, i):
            if i == 3:
                raise OSError("clip 3 is unreadable")
            return super().get_raw(i)

    pipe = DataPipeline(Broken(_items(5)), toks[1], SMALL, max_text_length=8, device="cpu")
    with pytest.raises(OSError, match="clip 3"):
        list(pipe.batches(1, np.random.default_rng(0), shuffle=False, epochs=1, prefetch=2))


def test_pipeline_and_bench_need_a_gpu_unless_asked_for_cpu(toks, monkeypatch):
    from audioldm_tpu_torch.tools import bench_dataprep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DataPipeline(AudioCaptionDataset(_items(2)), toks[1], SMALL)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench_dataprep.run(batch=1, batches=1)


def test_bench_dataprep_runs_its_stages_on_the_cpu(capsys):
    import json

    from audioldm_tpu_torch.config import VAEConfig
    from audioldm_tpu_torch.tools import bench_dataprep

    tiny = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4)
    recs = bench_dataprep.run(batch=2, batches=1, device="cpu", samples=SMALL.num_samples, vae_cfg=tiny)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines] == [r["metric"] for r in recs]
    assert recs[0]["shape"] == [2, 32, 64] and recs[1]["shape"] == [2, 4, 16, 32]
    assert all(r["finite"] for r in recs[:2]) and recs[0]["card"] == "cpu"
    assert recs[2]["metric"].startswith("dataprep_host")


@pytest.mark.slow
def test_make_batch_matches_jax_at_full_geometry(toks):
    rng = np.random.default_rng(16)
    items = [{"wav": _clip(rng, int(22050 * 12)), "sr": 22050, "caption": "hip hop music"},
             {"wav": _clip(rng, 160000), "sr": 16000, "caption": "rain"}]
    jtok, ttok = toks
    jp = jds.DataPipeline(jds.AudioCaptionDataset(items), jtok, JaxMelConfig(), freqm=48, timem=192)
    tp = DataPipeline(AudioCaptionDataset(items), ttok, MelConfig(), freqm=48, timem=192, device="cpu")
    jb, tb = jp.make_batch([0, 1], np.random.default_rng(17)), tp.make_batch([0, 1], np.random.default_rng(17))
    assert tb["log_mel_spec"].shape == (2, 1, 1024, 64) and tb["input_ids"].shape == (2, 64)
    _same_batch(jb, tb)
