"""Package installer; builds the native C++ image-op library alongside the
Python package (`pip install .` or `python setup.py build_ext`)."""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


class BuildNative(build_py):
    def run(self):
        native_dir = Path(__file__).parent / 'native'
        if (native_dir / 'Makefile').exists():
            try:
                subprocess.run(['make', '-C', str(native_dir)], check=True)
            except Exception as e:  # the package works without the .so
                print(f'warning: native build skipped ({e})')
        super().run()


setup(
    name='metrabs-tpu',
    version='0.1.0',
    description=('TPU-native absolute 3D human pose estimation '
                 '(JAX/XLA re-design of MeTRAbs)'),
    packages=find_packages(include=['metrabs_tpu', 'metrabs_tpu.*',
                                    'metrabs_tpu_torch', 'metrabs_tpu_torch.*']),
    package_data={'metrabs_tpu_torch': ['csrc/*.cu', 'assets/*.json']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'einops', 'numpy',
        'scipy', 'opencv-python', 'pillow',
    ],
    cmdclass={'build_py': BuildNative},
)
