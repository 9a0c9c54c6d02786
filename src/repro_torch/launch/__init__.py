"""Launch layer of the port: the meshes (``launch/mesh.py``), the serving
and training drivers (``serve.py``, ``train.py``) and the train step
(``steps.py``)."""
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_serving_mesh, mesh_chip_count

__all__ = ["Mesh", "make_host_mesh", "make_serving_mesh", "mesh_chip_count"]
