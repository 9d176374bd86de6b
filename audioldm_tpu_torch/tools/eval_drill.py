"""Full-geometry CLAP checkpoint -> ``cli score`` -> CLAP/KAD parity drill
for the port (its copy of the repo's ``tools/eval_drill.py``).

    python -m audioldm_tpu_torch.tools.eval_drill [--width full|quarter] [--clips 4] [--out DIR]

1. Builds a ``transformers.ClapModel`` at the ``laion/clap-htsat-fused``
   geometry (transformers' ``ClapConfig`` defaults with fusion on: HTSAT
   window 8, spec 256, depths 2-2-6-2, heads 4-8-16-32, embed 96 -> 768,
   projection 512; RoBERTa text 12 x 768), or the same graph at a quarter of
   the widths. The zero-initialised relative position bias tables and the
   identity BatchNorm statistics are randomised first, so that a dropped key
   or a wrong axis shows. The text vocabulary is 512, which the byte-level
   test tokenizer covers.
2. Writes it as an HF-layout CLAP directory (``model.safetensors``,
   ``config.json``, the tokenizer's ``vocab.json`` and ``merges.txt``) and
   two corpora of 48 kHz wavs (tones and noise, different seeds).
3. Runs ``python -m audioldm_tpu_torch.cli score --device cpu
   --generated --reference --prompt --output`` as a subprocess: the user's
   surface.
4. Computes the same numbers the reference's way in transformers:
   ``ClapFeatureExtractor`` a clip (truncation "fusion": a call of one clip
   sets ``is_longer``), ``get_audio_features``, the same tokenizer's ids and
   ``get_text_features``; CLAP score ``(cos + 1) / 2`` and KAD, the unbiased
   MMD^2 x100 with the ``torch.pdist`` median of the generated set as
   bandwidth.
5. Checks them against each other (per-clip scores, their mean, KAD) and
   that the check is not vacuous: an embedding spread above 1e-3, scores
   that are not all equal, a bandwidth off the 1.0 fallback.

It runs on the CPU wherever ``transformers`` and ``tokenizers`` are
installed. Bounds, about 10 times the largest gaps the drill has read on a
CPU (fp32 both sides: per-clip scores 1.8e-7 at full width and 2.7e-7 at a
quarter, KAD 2.4e-5 and 3.6e-5 of KADs near 2): ``SCORE_ATOL`` on each score
and their mean, ``KAD_ATOL`` on KAD (x100 scale). They sit below the 1e-5
floor the drill puts on the spread of the clips' scores, so a tower that is
slightly wrong fails. Exits 0 and prints a JSON line when they agree,
nonzero otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 48000
SCORE_ATOL, KAD_ATOL = 3e-6, 4e-4
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_tokenizer_files(folder: str) -> None:
    """A 300-entry byte-level BPE vocabulary (``vocab.json``, ``merges.txt``)
    trained on one repeated caption, with RoBERTa's special tokens."""
    from tokenizers.implementations import ByteLevelBPETokenizer

    corpus = os.path.join(folder, "_corpus.txt")
    with open(corpus, "w") as f:
        f.write("hip hop music with heavy bass and drums\n" * 30)
    tok = ByteLevelBPETokenizer()
    tok.train([corpus], vocab_size=300, min_frequency=1, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(folder)


def randomize_untrained(model, seed: int) -> None:
    """Fill the relative position bias tables (zero in a fresh model) and the
    BatchNorm statistics (identity) with seeded random values."""
    import torch

    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 1)
        for n, p in model.named_parameters():
            if "relative_position_bias_table" in n:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        for n, b in model.named_buffers():
            if "running_mean" in n:
                b.copy_(torch.randn(b.shape, generator=g) * 0.5)
            elif "running_var" in n:
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)


def build_clap_checkpoint(out_dir: str, width: str, seed: int = 0):
    """The HF-layout CLAP directory at ``full`` geometry or at a ``quarter``
    of its widths; returns the transformers model for the oracle."""
    import torch
    from transformers import ClapConfig, ClapModel

    from audioldm_tpu_torch.ckpt import write_safetensors

    text_cfg, audio_cfg, proj = dict(vocab_size=512), dict(enable_fusion=True), 512
    if width == "quarter":
        text_cfg.update(hidden_size=192, num_hidden_layers=12, num_attention_heads=4, intermediate_size=768,
                        projection_dim=128)
        audio_cfg.update(patch_embeds_hidden_size=24, hidden_size=192, num_attention_heads=[1, 2, 4, 8],
                         projection_dim=128)
        proj = 128
    torch.manual_seed(seed)
    model = ClapModel(ClapConfig(text_config=text_cfg, audio_config=audio_cfg, projection_dim=proj)).eval()
    randomize_untrained(model, seed)
    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), model.state_dict())
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f, indent=2)
    write_tokenizer_files(out_dir)
    return model


def make_wavs(folder: str, n: int, seed: int, seconds: float = 3.0) -> None:
    """``n`` seeded 48 kHz clips, four tones and band noise at 0.3 peak; the
    folder's earlier wavs are removed (both sides score every wav in it)."""
    from audioldm_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    os.makedirs(folder, exist_ok=True)
    for stale in os.listdir(folder):
        if stale.endswith(".wav"):
            os.remove(os.path.join(folder, stale))
    for i in range(n):
        freqs, amps = rng.uniform(80.0, 4000.0, size=4), rng.uniform(0.05, 0.15, size=4)
        wav = sum(a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) for f, a in zip(freqs, amps))
        wav = wav + 0.05 * rng.standard_normal(t.shape)
        write_wav(os.path.join(folder, f"{i:03d}.wav"), (0.3 * wav / np.abs(wav).max()).astype(np.float32), SR)


def torch_oracle(model, clap_dir: str, gen_dir: str, ref_dir: str, prompt: str) -> dict:
    """The reference's eval arithmetic in transformers, from the same wav
    files and the same tokenizer ids as the CLI."""
    import torch
    import torch.nn.functional as F
    from transformers import ClapFeatureExtractor

    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.data.wavio import read_wav

    fe = ClapFeatureExtractor()

    def embed_dir(folder):
        embs = []
        for name in sorted(os.listdir(folder)):
            if name.endswith(".wav"):
                wav, sr = read_wav(os.path.join(folder, name))
                assert sr == SR
                with torch.no_grad():
                    e = model.get_audio_features(**fe(wav, sampling_rate=SR, return_tensors="pt"))
                embs.append(F.normalize(e, dim=-1)[0])
        return torch.stack(embs)

    gen, ref = embed_dir(gen_dir), embed_dir(ref_dir)
    enc = load_tokenizer(clap_dir)([prompt], max_length=77)
    with torch.no_grad():
        te = model.get_text_features(input_ids=torch.from_numpy(np.asarray(enc["input_ids"], np.int64)),
                                     attention_mask=torch.from_numpy(np.asarray(enc["attention_mask"], np.int64)))
    te = F.normalize(te, dim=-1)
    clap_scores = (((gen @ te.T).squeeze(1) + 1.0) / 2.0).numpy()

    bw = float(torch.median(torch.pdist(gen.float())))
    fallback = bw < 1e-6 or np.isnan(bw)
    if fallback:
        bw = 1.0
    gamma = 1.0 / (2.0 * bw**2 + 1e-8)

    def mmd_term(a, b, cross):
        k = torch.exp(-gamma * ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)))
        if cross:
            return k.mean()
        k = k - torch.diag(torch.diagonal(k))
        return k.sum() / (a.shape[0] * (a.shape[0] - 1))

    x, y = ref.float(), gen.float()
    kad = float((mmd_term(x, x, False) + mmd_term(y, y, False) - 2 * mmd_term(x, y, True)) * 100.0)
    spread = float(torch.median(torch.pdist(torch.cat([gen, ref]).float())))
    return {"clap_scores": clap_scores, "clap_score_mean": float(clap_scores.mean()), "kad": kad, "bandwidth": bw,
            "bandwidth_fallback": fallback, "embed_spread": spread}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--width", choices=["full", "quarter"], default="full")
    ap.add_argument("--clips", type=int, default=4, help="wavs a corpus")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt", default="hip hop beat with heavy bass")
    ap.add_argument("--out", default=None, help="work dir (default: a temp dir)")
    args = ap.parse_args(argv)

    work = args.out or tempfile.mkdtemp(prefix="eval_drill_")
    clap_dir, gen_dir, ref_dir = (os.path.join(work, n) for n in ("clap", "gen", "ref"))
    t0 = time.time()
    model = build_clap_checkpoint(clap_dir, args.width, seed=args.seed)
    make_wavs(gen_dir, args.clips, seed=args.seed + 100, seconds=args.seconds)
    make_wavs(ref_dir, args.clips, seed=args.seed + 200, seconds=args.seconds)
    print(f"# {args.width}-geometry CLAP checkpoint and corpora in {time.time() - t0:.1f}s", file=sys.stderr)

    out_json = os.path.join(work, "scores.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "audioldm_tpu_torch.cli", "score", "--checkpoint", clap_dir, "--generated", gen_dir,
           "--reference", ref_dir, "--prompt", args.prompt, "--output", out_json, "--device", "cpu"]
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
        raise SystemExit(f"cli score failed (exit {proc.returncode})")
    cli_s = time.time() - t0
    with open(out_json) as f:
        ours = json.load(f)
    oracle = torch_oracle(model, clap_dir, gen_dir, ref_dir, args.prompt)

    if oracle["bandwidth_fallback"]:
        raise SystemExit("VACUOUS: the KAD bandwidth is the 1.0 fallback: degenerate embeddings")
    if oracle["embed_spread"] < 1e-3:
        raise SystemExit(f"VACUOUS: embedding spread {oracle['embed_spread']:.2e}: all clips map to one embedding")
    if float(np.std(oracle["clap_scores"])) < 1e-5:
        raise SystemExit("VACUOUS: the per-clip CLAP scores are all equal")

    score_diff = np.abs(np.asarray(ours["clap_scores"]) - oracle["clap_scores"])
    mean_diff = abs(ours["clap_score_mean"] - oracle["clap_score_mean"])
    kad_diff = abs(ours["kad"] - oracle["kad"])
    result = {
        "drill": f"{args.width}@{args.clips}clips/{args.seconds}s", "device": "cpu",
        "clap_score_mean_ours": ours["clap_score_mean"], "clap_score_mean_oracle": oracle["clap_score_mean"],
        "clap_score_max_diff": float(score_diff.max()), "kad_ours": ours["kad"], "kad_oracle": oracle["kad"],
        "kad_diff": kad_diff, "bandwidth": oracle["bandwidth"], "embed_spread": oracle["embed_spread"],
        "score_atol": SCORE_ATOL, "kad_atol": KAD_ATOL,
        "pass": bool(score_diff.max() <= SCORE_ATOL and mean_diff <= SCORE_ATOL and kad_diff <= KAD_ATOL),
        "cli_s": cli_s,
    }
    print(json.dumps(result))
    if not result["pass"]:
        raise SystemExit(f"PARITY FAIL: clap max|diff| {score_diff.max():.3e} (atol {SCORE_ATOL}), "
                         f"kad |diff| {kad_diff:.3e} (atol {KAD_ATOL})")
    return result


if __name__ == "__main__":
    main()
