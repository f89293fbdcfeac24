"""Wheel build: ship the native C++ sources inside both packages so the
runtime self-build (kanzi_tpu/utils/native.py and
kanzi_tpu_torch/utils/native.py) works from an installed wheel exactly
like from the repo checkout (the .so files are compiled lazily with g++
on first use: kanzi_tpu caches them next to the sources, kanzi_tpu_torch
under build/kanzi_tpu_torch/native)."""

import shutil
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithNative(build_py):
    def run(self):
        super().run()
        root = Path(__file__).parent
        for pkg in ("kanzi_tpu", "kanzi_tpu_torch"):
            dest = Path(self.build_lib) / pkg / "native"
            dest.mkdir(parents=True, exist_ok=True)
            for src in (root / "native").glob("*.cpp"):
                shutil.copy2(src, dest / src.name)
            for src in (root / "native").glob("*.h"):
                shutil.copy2(src, dest / src.name)


setup(cmdclass={"build_py": BuildPyWithNative})
