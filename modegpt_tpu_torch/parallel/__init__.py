from modegpt_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape

__all__ = ["make_mesh", "parse_mesh_shape"]
