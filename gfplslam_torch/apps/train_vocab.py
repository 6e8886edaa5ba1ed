"""Train binary bag-of-words vocabularies from sequence descriptors.

Port of ``gfplslam_tpu/apps/train_vocab.py`` (DBoW2's offline vocabulary
training, TemplatedVocabulary.h:135-162): binary k-means (k-majority:
cluster center = bitwise majority of members) over descriptors harvested
from synthetic frames, written as an anchor vocabulary npz that
``models/loop.py`` ``load_vocab`` installs. Runs on the CUDA card unless
``--device`` names another.

Usage:
  python -m gfplslam_torch.apps.train_vocab --synthetic --frames 20 \
      -o vocab.npz --words 256
"""

from __future__ import annotations

import argparse

import numpy as np

# rows of descriptors per Hamming launch in the assignment step: an
# [8192, k] int32 matrix (134 MB at k = 4096)
ASSIGN_BLOCK = 8192


def unpack_bits(desc: np.ndarray) -> np.ndarray:
    """[N, 8] uint32 -> [N, 256] uint8 bits."""
    b = desc.view(np.uint8).reshape(len(desc), -1)
    return np.unpackbits(b, axis=1, bitorder="little")


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[N, 256] bits -> [N, 8] uint32."""
    by = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return by.view(np.uint32)


def _desc_tensor(desc: np.ndarray, device):
    import torch
    return torch.as_tensor(np.ascontiguousarray(desc, np.uint32).view(np.int32),
                           device=device)


def assign_words(packed, centers):
    """Nearest center of every descriptor row (first index on ties), one
    Hamming launch per ``ASSIGN_BLOCK`` rows. ``packed`` [N, 8] and
    ``centers`` [k, 8] int32 on one device -> [N] int64."""
    import torch
    from gfplslam_torch.ops.hamming import hamming_matrix
    return torch.cat([torch.argmin(hamming_matrix(packed[s:s + ASSIGN_BLOCK],
                                                  centers), dim=1)
                      for s in range(0, packed.shape[0], ASSIGN_BLOCK)])


def kmajority(desc: np.ndarray, k: int, iters: int = 10,
              seed: int = 0, device="cuda") -> np.ndarray:
    """Binary k-means with majority-vote centers (DBoW2's descriptor
    clustering, TemplatedVocabulary.h initiateClusters/meanValue).

    Assignment is the Hamming kernel over row blocks; the majority vote is
    ONE one-hot fp32 matmul ``assign_onehot.T @ bits``, whose sums are
    integers below 2^24 and so exact in fp32 (TF32 stays off: the package
    turns it off at import). The centers come back to the host once per
    iteration, for the convergence test."""
    import torch

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    n = len(desc)
    bits = torch.as_tensor(unpack_bits(desc), device=device).float()  # [N, 256]
    packed = _desc_tensor(desc, device)                                # [N, 8]
    centers = desc[rng.choice(n, size=k, replace=n < k)]               # [k, 8]
    for _ in range(iters):
        assign = assign_words(packed, _desc_tensor(centers, device))
        reseed_bits = torch.as_tensor(unpack_bits(desc[rng.choice(n, size=k)]),
                                      device=device)
        onehot = torch.nn.functional.one_hot(assign, k).float()        # [N, k]
        counts = onehot.sum(0)                                         # [k]
        sums = onehot.T @ bits                                         # [k, 256]
        maj = (sums * 2.0 > counts[:, None]).to(torch.uint8)
        # empty clusters re-seed from random members
        maj = torch.where(counts[:, None] > 0, maj, reseed_bits)
        new_centers = pack_bits(maj.cpu().numpy())
        if np.array_equal(new_centers, centers):
            break
        centers = new_centers
    return centers


def document_frequencies(vocab: np.ndarray, docs: list,
                         device="cuda") -> np.ndarray:
    """[V] document frequencies: number of training frames whose descriptor
    set contains each word (DBoW2 computes idf from the training corpus and
    FREEZES it, TemplatedVocabulary.h:1066-1127 setNodeWeights)."""
    import torch

    device = torch.device(device)
    vb = _desc_tensor(vocab, device)
    df = np.zeros(len(vocab), np.int64)
    for d in docs:
        if not len(d):
            continue
        words = np.unique(assign_words(_desc_tensor(d, device), vb).cpu().numpy())
        df[words] += 1
    return df


def harvest_descriptors(args):
    """Descriptors from several distinct synthetic worlds/motions — the
    stand-in for the reference's multi-dataset training corpus
    (voc_all_datasets_*, config.cpp:59-60). Returns flat descriptor arrays
    plus the per-frame document lists for idf training."""
    import torch
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.frame import process_stereo_pair

    device = torch.device(args.device)
    cfg = Config(
        cap=CapacityParams(n_pt=256, n_ln=128), orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11))
    # diverse corpus: three motions x blob tier + textured raycast tier +
    # extra scene seeds (cross-SCENE discrimination needs words that split
    # scenes, not only viewpoints)
    specs = [(17, "forward", False), (41, "orbit", False),
             (73, "loop", False), (21, "loop", True), (55, "forward", True),
             (8, "forward", False), (99, "forward", False)]
    if args.words >= 1024:
        # large codebooks need a larger/more diverse corpus: ~16 scenes
        # spanning every motion family and both render tiers (k-majority
        # with fewer than ~10 members per word degenerates to memorized
        # descriptors)
        specs += [(s, m, tex)
                  for s, m in [(5, "circuit"), (29, "circuit"),
                               (61, "orbit"), (83, "loop"), (123, "forward"),
                               (151, "orbit"), (203, "circuit")]
                  for tex in (False, True)]
    worlds = [synthetic.make_world(n_frames=args.frames, seed=s, motion=m,
                                   n_points=400, n_lines=50,
                                   cam=cfg.camera, textured=tex)
              for s, m, tex in specs]
    th = torch.tensor(20.0, device=device)
    pt_desc, ln_desc = [], []
    for world in worlds:
        for i in range(0, args.frames, 2):
            il, ir = synthetic.render_frame(world, i)
            f = process_stereo_pair(torch.as_tensor(il, device=device),
                                    torch.as_tensor(ir, device=device), cfg, th)
            pv = f.points.valid.cpu().numpy()
            lv = f.lines.valid.cpu().numpy()
            pt_desc.append(f.points.desc.cpu().numpy().view(np.uint32)[pv])
            ln_desc.append(f.lines.desc.cpu().numpy().view(np.uint32)[lv])
    return (np.concatenate(pt_desc), np.concatenate(ln_desc),
            pt_desc, ln_desc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true", required=True)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--words", type=int, default=256)
    ap.add_argument("-o", "--out", default="vocab.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    pt_desc, ln_desc, pt_docs, ln_docs = harvest_descriptors(args)
    print(f"harvested {len(pt_desc)} point / {len(ln_desc)} line descriptors")
    vp = kmajority(pt_desc, args.words, iters=20, device=args.device)
    vl = kmajority(ln_desc, min(args.words, max(16, len(ln_desc) // 4)),
                   iters=20, device=args.device)
    if len(vl) < args.words:  # pad with random anchors to the word count
        rng = np.random.default_rng(5)
        pad = rng.integers(0, 2 ** 32, size=(args.words - len(vl), 8),
                           dtype=np.uint32)
        vl = np.concatenate([vl, pad])
    # frozen training-corpus idf (DBoW2 semantics): scores stay on one scale
    # no matter how many KFs the online map accumulates
    df_p = document_frequencies(vp, pt_docs, device=args.device)
    df_l = document_frequencies(vl, ln_docs, device=args.device)
    n_docs = len(pt_docs)
    np.savez(args.out, vocab_p=vp, vocab_l=vl, df_p=df_p, df_l=df_l,
             n_docs=np.asarray(n_docs))
    print(f"wrote {args.out}: {vp.shape} point words, {vl.shape} line words, "
          f"df over {n_docs} docs")


if __name__ == "__main__":
    main()
