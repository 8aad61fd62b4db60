"""Image and result IO for evaluation runs.

Port of sph_tpu/utils/io.py (reference: sph/utils/EvalIO.cpp —
loadTiffImageStack (multi-page float TIFF stacks), loadRGBdata (JPEG/PNG to
a float stack), per-level TIFF label images, settings snapshots and short
hashes).  Pillow reads and writes every image format, as in the JAX
package, so each file written here is byte-equal to the JAX package's for
the same input.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..data import ImageStack
from .logging import Log


def load_tiff_image_stack(path: str, name: str = "") -> ImageStack:
    """Multi-page TIFF -> [N, pages] pixel-major stack (reference:
    loadTiffImageStack, EvalIO.hpp:49-53; pages are channels)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        pages = [np.asarray(page, dtype=np.float32)
                 for page in ImageSequence.Iterator(im)]
    if not pages:
        Log.warn("load_tiff_image_stack: no pages in %s", path)
        return ImageStack(np.zeros((0, 1), np.float32), 0, 0, name)
    stack = np.stack(pages, axis=-1)  # [rows, cols, channels]
    if stack.ndim == 4:  # multi-channel pages
        r, c = stack.shape[:2]
        stack = stack.reshape(r, c, -1)
    return ImageStack.from_array(stack, name or os.path.basename(path))


def load_rgb_data(path: str, name: str = "") -> ImageStack:
    """JPEG/PNG -> float [N, 3] stack (reference: loadRGBdata,
    EvalIO.hpp:70-75)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32)
    return ImageStack.from_array(arr, name or os.path.basename(path))


def load_image(path: str, img_format: str = "auto") -> ImageStack:
    fmt = img_format.lower()
    if fmt == "auto":
        fmt = ("tiffstack" if path.lower().endswith((".tif", ".tiff"))
               else "rgb")
    if fmt == "tiffstack":
        return load_tiff_image_stack(path)
    return load_rgb_data(path)


def save_tiff_stack(path: str, img: np.ndarray) -> None:
    """A [rows, cols, channels] float32 stack as a multi-page TIFF, one
    channel a page (scripts/make_data.py's writer)."""
    from PIL import Image

    img = np.asarray(img, dtype=np.float32)
    pages = [Image.fromarray(np.ascontiguousarray(img[:, :, c]), mode="F")
             for c in range(img.shape[2])]
    pages[0].save(path, save_all=True, append_images=pages[1:])


def save_label_image(labels: np.ndarray, rows: int, cols: int, path: str):
    """Per-pixel component labels as a float TIFF (reference:
    saveSingleImage / saveLevelImages, EvalIO.hpp:62)."""
    from PIL import Image

    img = np.asarray(labels, dtype=np.float32).reshape(rows, cols)
    Image.fromarray(img, mode="F").save(path)


def load_label_image(path: str) -> np.ndarray:
    """A label TIFF back as a flat float32 array."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32).ravel()


def save_level_images(hierarchy, rows: int, cols: int, out_dir: str):
    """Per-level label TIFFs ``level_<l>.tiff`` (reference: saveLevelImages,
    RunEvaluation.cpp:345)."""
    os.makedirs(out_dir, exist_ok=True)
    for level in range(hierarchy.num_levels):
        save_label_image(hierarchy.pixel_components[level], rows, cols,
                         os.path.join(out_dir, f"level_{level}.tiff"))


def write_embedding(path: str, emb: np.ndarray):
    """Raw float32 binary, interleaved xy (reference: writeVecToBinary of
    the embedding container, RunEvaluation.cpp:488-530)."""
    np.asarray(emb, dtype=np.float32).ravel().tofile(path)


def read_embedding(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 2)


def create_short_hash(text: str, length: int = 8) -> str:
    """Reference: createShortHash (EvalIO.hpp:96-102)."""
    return hashlib.sha256(text.encode()).hexdigest()[:length]


def save_settings_snapshot(path: str, *settings_objs):
    """Human-readable settings dump (reference: saveCurrentSettings,
    RunEvaluation.cpp:341)."""
    from ..settings import settings_to_dict
    with open(path, "w") as f:
        for s in settings_objs:
            json.dump(settings_to_dict(s), f, indent=2)
            f.write("\n")


def save_setting_hashes(path: str, hashes: list[tuple[str, str]]):
    """Hash registry (reference: saveSettingHashes)."""
    with open(path, "w") as f:
        json.dump({h: s for h, s in hashes}, f, indent=2)


def write_vec_of_vec(path: str, vecs):
    """Length-prefixed int64 binary for ragged int lists (stand-in for the
    reference's writeVecOfVecToBinary family, FileIO.hpp)."""
    with open(path, "wb") as f:
        np.int64(len(vecs)).tofile(f)
        for v in vecs:
            arr = np.asarray(v, dtype=np.int64)
            np.int64(arr.size).tofile(f)
            arr.tofile(f)


def read_vec_of_vec(path: str):
    out = []
    with open(path, "rb") as f:
        n = int(np.fromfile(f, np.int64, 1)[0])
        for _ in range(n):
            ln = int(np.fromfile(f, np.int64, 1)[0])
            out.append(np.fromfile(f, np.int64, ln))
    return out
