"""Pallas kernels (GPU Triton route) for the column steps.

The physics itself lives in ``ops``/``models`` as pure jnp functions; a
kernel here applies the same functions to one tile of columns, so the
kernel layer only controls the launch shape and memory movement.
"""

from .column1m import step_column_1m_triton
from .column2m import step_column_2m_triton
