"""File system helpers (src/io/IOUtil.hpp:60-302).

Recursive file listing with symlink/dot-file flags and stable sorting by
path or size; mkdir -p equivalents.
"""

from __future__ import annotations

import os
from typing import List, Tuple


def create_file_list(path: str, is_recursive: bool = True,
                     ignore_links: bool = False,
                     ignore_dot_files: bool = False) -> List[Tuple[str, int]]:
    """Returns [(path, size)] for regular files under path."""
    out: List[Tuple[str, int]] = []
    if os.path.isfile(path):
        if not (ignore_dot_files and os.path.basename(path).startswith(".")):
            out.append((path, os.path.getsize(path)))
        return out
    if not os.path.isdir(path):
        raise FileNotFoundError(f"Cannot access input file '{path}'")
    for root, dirs, files in os.walk(path, followlinks=not ignore_links):
        if ignore_dot_files:
            dirs[:] = [d for d in dirs if not d.startswith(".")]
            files = [f for f in files if not f.startswith(".")]
        if not is_recursive:
            dirs[:] = []
        for f in sorted(files):
            full = os.path.join(root, f)
            if ignore_links and os.path.islink(full):
                continue
            if os.path.isfile(full):
                out.append((full, os.path.getsize(full)))
    return out


def sort_files_by_path_and_size(files, by_size_first: bool = False):
    """Stable sort by path, or (size desc, path) when by_size_first."""
    if by_size_first:
        return sorted(files, key=lambda fs: (-fs[1], fs[0]))
    return sorted(files, key=lambda fs: fs[0])


def mkdir_all(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def same_paths(a: str, b: str) -> bool:
    try:
        return os.path.samefile(a, b)
    except OSError:
        return os.path.abspath(a) == os.path.abspath(b)
