"""Filesystem helpers.

``list_files_with_ext`` is a copy of
``gan_segmentation_tpu/utils/io.py::list_files_with_ext`` (the JAX package's
``utils`` is importable without jax, but the port imports nothing of that
package except ``native``); ``tests/test_torch_data.py`` pins the two
together.
"""

from os import walk
from os.path import isdir, isfile, islink, join, sep, splitext
from typing import List, Sequence


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
