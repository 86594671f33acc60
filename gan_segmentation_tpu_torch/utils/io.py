"""Filesystem helpers (`utils.py:18-66` in the reference).

``list_subdirs``, ``list_files_with_ext`` and ``list_images`` are copies of
``gan_segmentation_tpu/utils/io.py``'s (that module imports no jax, but the
port imports nothing of the JAX package); ``tests/test_torch_data.py`` and
``tests/test_torch_helpers.py`` pin them together.
"""

from os import listdir, walk
from os.path import isdir, isfile, islink, join, sep, splitext
from typing import List, Sequence


def list_subdirs(base_dir: str) -> List[str]:
    """The names of ``base_dir``'s subdirectories, in ``listdir``'s order
    (`utils.py:9-15`)."""
    return [f for f in listdir(base_dir) if isdir(join(base_dir, f))]


def list_files_with_ext(base_dir: str, valid_exts: Sequence[str],
                        recursive: bool = False) -> List[str]:
    """Sorted relative paths under ``base_dir`` with one of ``valid_exts``.
    Like the reference, the non-recursive variant still descends into
    subdirectories; ``recursive`` only toggles following symlinks."""
    assert isdir(base_dir) or islink(base_dir), f"{base_dir} is not a directory"
    out = []
    base_len = len(base_dir.split(sep))
    for root, _dirs, fnames in sorted(walk(base_dir, followlinks=recursive)):
        rel_root = sep.join(root.split(sep)[base_len:])
        for fname in sorted(fnames):
            if not isfile(join(root, fname)):
                continue
            if splitext(fname.lower())[1] not in valid_exts:
                continue
            out.append(join(rel_root, fname) if rel_root else fname)
    return out


def list_images(base_dir: str,
                valid_exts=(".jpg", ".jpeg", ".png", ".bmp", ".ppm")
                ) -> List[str]:
    """``list_files_with_ext`` over the image extensions."""
    return list_files_with_ext(base_dir, valid_exts)
