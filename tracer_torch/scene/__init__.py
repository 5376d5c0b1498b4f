from tracer_torch.scene.io import load_obj, save_obj
from tracer_torch.scene.procedural import (
    bunny_scene, columned_hall, cornell_box, random_tri_soup)
from tracer_torch.scene.types import (
    Lights, Materials, Scene, compute_vertex_normals, merge_meshes)

__all__ = [
    "Scene", "Materials", "Lights", "compute_vertex_normals", "merge_meshes",
    "cornell_box", "bunny_scene", "columned_hall", "random_tri_soup",
    "load_obj", "save_obj",
]
