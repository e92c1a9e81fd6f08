"""Qualitative retrieval panels (port of ``plot_exemples.py:30-100``).

For one or two runs, embeds the query and gallery sets, retrieves the
top-k with ``ops.knn`` (``lax.top_k``'s order: among equal scores the lower
gallery index first, as Hamming codes tie often) and writes a PNG grid:
each row is a query (blue border) and its top-k results (green border if
relevant, red if not) on a white canvas.

The port reads images as (H, W, 3) uint8 arrays and has no Pillow:
thumbnails are ``transforms.host.resize`` with the bicubic filter, Pillow's
``Image.resize`` default and arithmetic; borders are constant padding in
Pillow's colours (``blue`` (0, 0, 255), ``green`` (0, 128, 0), ``red``
(255, 0, 0)); the PNG is written by ``write_png`` (zlib + struct).

    python -m irw_tpu_torch.plot_exemples --run experiments/a
        [--run2 experiments/b] --num-queries 6 --topk 5 --out panels.png
        [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import struct
import zlib

import numpy as np
import torch

from irw_tpu_torch.engine.evaluate import compute_embeddings
from irw_tpu_torch.ops.knn import knn
from irw_tpu_torch.run_dir import load_run
from irw_tpu_torch.transforms.host import BICUBIC, resize
from irw_tpu_torch.utils.label_matrix import create_label_matrix

LOGGER = logging.getLogger(__name__)
COLORS = {"blue": (0, 0, 255), "green": (0, 128, 0), "red": (255, 0, 0)}   # Pillow's names


def thumbnail(img: np.ndarray, thumb: int) -> np.ndarray:
    """(H, W, 3) uint8 → (thumb, thumb, 3), as Pillow's ``resize((thumb,
    thumb))`` (bicubic)."""
    return resize(img, thumb, thumb, BICUBIC)


def retrieval_rows(run_dir, num_queries: int, topk: int, thumb: int = 96, device=None):
    """One row a query, for the first ``num_queries`` queries of the run's
    test split: [(thumbnail, colour name)], the query's first (``blue``),
    then its ``topk`` results (``green`` relevant, ``red`` not)."""
    run = load_run(run_dir, device)
    datasets = run.eval_split("test")
    if isinstance(datasets, dict):
        query_ds, gallery_ds = datasets["query"], datasets["gallery"]
        same = False
    else:
        query_ds = gallery_ds = datasets
        same = True
    metric = (run.config.experience.get("evaluation") or {}).get("distance_metric", "cosine")
    q_emb, q_labels = compute_embeddings(run.model, query_ds, run.device_test, device=run.device,
                                         host_transform=run.host_test)
    g_emb, g_labels = compute_embeddings(run.model, gallery_ds, run.device_test,
                                         device=run.device, host_transform=run.host_test)
    idx, _ = knn(q_emb, g_emb, k=topk, metric=metric, same_source=same)
    idx = idx.cpu().numpy()
    rel = create_label_matrix(torch.as_tensor(np.asarray(q_labels)),
                              torch.as_tensor(np.asarray(g_labels))).numpy()
    rows = []
    for q in range(min(num_queries, len(query_ds))):
        tiles = [(thumbnail(query_ds.load_image(q), thumb), "blue")]
        for g in idx[q]:
            color = "green" if rel[q, g] > 0 else "red"
            tiles.append((thumbnail(gallery_ds.load_image(int(g)), thumb), color))
        rows.append(tiles)
    return rows


def render(rows_list, out_path, thumb: int = 96, border: int = 3, gap: int = 8) -> np.ndarray:
    """Draw ``rows_list`` (one ``retrieval_rows`` result a run, stacked) on
    a white canvas, each tile framed by ``border`` pixels of its colour and
    ``gap`` pixels apart, and write it to ``out_path`` as a PNG.  Returns
    the canvas, (H, W, 3) uint8."""
    n_rows = sum(len(rows) for rows in rows_list)
    n_cols = max(len(r) for rows in rows_list for r in rows)
    cell = thumb + 2 * border
    canvas = np.full((n_rows * (cell + gap), n_cols * (cell + gap), 3), 255, np.uint8)
    y = 0
    for rows in rows_list:
        for tiles in rows:
            x = 0
            for img, color in tiles:
                canvas[y:y + cell, x:x + cell] = COLORS[color]   # ImageOps.expand's border
                canvas[y + border:y + border + thumb, x + border:x + border + thumb] = img
                x += cell + gap
            y += cell + gap
    write_png(out_path, canvas)
    LOGGER.info(f"wrote {out_path}")
    return canvas


def write_png(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (no filter, zlib)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.ascontiguousarray(rows).tobytes()))
                + chunk(b"IEND", b""))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", required=True)
    parser.add_argument("--run2", default=None)
    parser.add_argument("--num-queries", type=int, default=6)
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--out", default="retrieval_panels.png")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args()
    panels = [retrieval_rows(args.run, args.num_queries, args.topk, device=args.device)]
    if args.run2:
        panels.append(retrieval_rows(args.run2, args.num_queries, args.topk, device=args.device))
    render(panels, args.out)
