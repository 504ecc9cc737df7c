"""External data-artifact resolution.

JAX counterpart of the reference's lazy-artifact subsystem
(``/root/reference/src/ArtifactCalling.jl:17-19``): the reference pulls
the AIDA ice-nucleation chamber dataset from a remote artifact store on
first use. Here, artifacts are resolved from a local directory — the
``CMT_ARTIFACTS_DIR`` environment variable, or ``~/.cache/cmt_artifacts``
— with a clear offline error when missing (this build environment has no
network egress; drop files in the directory to register them).
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["artifacts_dir", "AIDA_ice_nucleation", "ArtifactMissingError"]


class ArtifactMissingError(FileNotFoundError):
    """Raised when a named artifact is not present locally."""


def artifacts_dir() -> Path:
    return Path(os.environ.get(
        "CMT_ARTIFACTS_DIR",
        Path.home() / ".cache" / "cmt_artifacts"))


def AIDA_ice_nucleation(data_file_name: str) -> Path:
    """Path to an AIDA chamber data file
    (reference src/ArtifactCalling.jl:17-19).

    Files live under ``<artifacts_dir>/AIDA_ice_nucleation/``."""
    p = artifacts_dir() / "AIDA_ice_nucleation" / data_file_name
    if not p.exists():
        raise ArtifactMissingError(
            f"AIDA artifact {data_file_name!r} not found at {p}. This "
            "environment has no network egress; place the file there "
            "manually or set CMT_ARTIFACTS_DIR.")
    return p
