"""Launch layer of the port: the meshes (``launch/mesh.py``), the serving
and training entry points (``serve.py``, ``train.py``), the steps
(``steps.py``) and the dry run (``dryrun.py`` with ``analytic.py`` and
``hlo_analysis.py``)."""
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_production_mesh,
                                     make_serving_mesh, mesh_chip_count)

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh", "make_serving_mesh",
           "mesh_chip_count"]
