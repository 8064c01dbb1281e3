"""JSON parameter handling (ParameterHandler::parse_input_from_json analog,
benchmark_01.cc:3-32) and the bulk config generator used by the experiment
scripts (experiments-skx/generate_files.py analog)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

__all__ = ["BenchmarkParameters", "generate_parameter_files"]


@dataclass
class BenchmarkParameters:
    """Keys mirror the reference's JSON schema (benchmark_01.cc:10-17)."""

    geometry_type: str = "quadrant"
    n_refinements: int = 6
    degree: int = 4
    setup_only_fast_algorithm: bool = True
    test_high_order_mapping: bool = False
    categorize: bool = False
    vectorization_type: str = "index"  # index | sorted | group | matrix
    print_details: bool = True

    _JSON_KEYS = {
        "GeometryType": "geometry_type",
        "NRefinements": "n_refinements",
        "Degree": "degree",
        "SetupOnlyFastAlgorithm": "setup_only_fast_algorithm",
        "TestHighOrderMapping": "test_high_order_mapping",
        "Categorize": "categorize",
        "VectorizationType": "vectorization_type",
        "PrintDetail": "print_details",
    }

    @classmethod
    def from_json(cls, path: str) -> "BenchmarkParameters":
        with open(path) as f:
            data = json.load(f)
        kwargs = {}
        for jk, attr in cls._JSON_KEYS.items():
            if jk in data:
                val = data[jk]
                field_type = cls.__dataclass_fields__[attr].type
                if field_type == "int":
                    val = int(val)
                elif field_type == "bool":
                    val = val in (True, "true", "True", 1, "1")
                kwargs[attr] = val
        return cls(**kwargs)

    def to_json(self, path: str) -> None:
        data = {
            jk: getattr(self, attr) for jk, attr in self._JSON_KEYS.items()
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @property
    def hn_mode(self) -> str:
        """Map the reference's VectorizationType to our kernel variants
        ("matrix" is the composite-matmul 4th runner with no reference
        analog)."""
        return {
            "index": "compact",
            "sorted": "sorted",
            "group": "all",
            "matrix": "matrix",
        }[self.vectorization_type]


def generate_parameter_files(
    out_dir: str,
    geometries=("quadrant", "annulus"),
    refinements=(6,),
    degrees=(1, 2, 3, 4),
    vectorization_types=("index", "sorted", "group"),
    **overrides,
):
    """Bulk-generate JSON configs (generate_files.py:24-85 analog)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for g in geometries:
        for r in refinements:
            for d in degrees:
                for v in vectorization_types:
                    p = BenchmarkParameters(
                        geometry_type=g,
                        n_refinements=r,
                        degree=d,
                        vectorization_type=v,
                        categorize=(v == "sorted"),
                        **overrides,
                    )
                    path = os.path.join(out_dir, f"{g}_r{r}_p{d}_{v}.json")
                    p.to_json(path)
                    paths.append(path)
    return paths
