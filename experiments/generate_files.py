#!/usr/bin/env python
"""Bulk JSON config generation (experiments-skx/generate_files.py analog)."""

import sys

try:
    import dealii_matrixfree_hanging_nodes  # noqa: F401
except ModuleNotFoundError:  # checkout use without `pip install -e .`
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

from dealii_matrixfree_hanging_nodes.utils.params import generate_parameter_files

if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "experiments/configs"
    paths = generate_parameter_files(out)
    print("\n".join(paths))
