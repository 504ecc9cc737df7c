"""cloudmicrophysics_tpu — a JAX cloud microphysics framework.

A from-scratch JAX/XLA re-design of the capabilities of
CliMA/CloudMicrophysics.jl: bulk microphysics schemes (0/1/2-moment and P3
predicted-particle-properties), ice nucleation, aerosol activation
(ARG2000), non-equilibrium condensation, cloud diagnostics, and the 0-D
parcel/box driver models — built as fused elementwise kernels over
device-resident ``(ncol, nlev)`` column arrays, sharded across device
meshes.

Layout (mirrors SURVEY.md layers):

* ``utils/``      — L0 numerics (incomplete gamma, quadrature, distributions)
* ``parameters/`` — L1 frozen parameter structs + TOML-style defaults
* ``ops/``        — L2-L4 physics: thermodynamics bridge, shared helpers,
                    scheme modules (0M/1M/2M/NonEq/IceNucleation/P3/aerosol)
* ``models/``     — L5/L6 fused tendency API, column model, parcel/box drivers
* ``parallel/``   — device-mesh sharding (column data parallelism)
* ``kernels/``    — Pallas kernels (GPU Triton route) for the column steps
"""

__version__ = "0.1.0"

from . import models, ops, parallel, parameters, utils
