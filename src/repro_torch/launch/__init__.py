"""Command-line drivers of the port (serve, train, the dry run) and the
roofline model the dry run reports with."""

from repro_torch.launch.mesh import (data_axes_of, make_local_mesh,
                                     make_production_mesh, model_axes_of)

__all__ = ["make_production_mesh", "make_local_mesh", "data_axes_of",
           "model_axes_of"]
