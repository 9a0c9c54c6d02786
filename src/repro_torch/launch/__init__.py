"""Launch layer of the port: the serving meshes (``launch/mesh.py``)."""
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_serving_mesh, mesh_chip_count

__all__ = ["Mesh", "make_host_mesh", "make_serving_mesh", "mesh_chip_count"]
