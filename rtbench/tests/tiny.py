"""Tiny copies of the cells for CPU tests: the same files, with a small scene
of the same kind and a small frame."""
import copy

from rtbench import harness, scenes

SCENES = {"bench100k": {"kind": "bench", "subdiv": 1},
          "bunny512": {"kind": "bunny", "subdiv": 2}}


def tiny_cell(name: str, height: int = 32, width: int = 32) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    scene = SCENES[cell.config_name]
    cell.config["scene"] = scene
    cell.config["triangles"] = len(scenes.make(scene).tris)
    cell.config["render"] = dict(cell.config["render"], height=height, width=width)
    return cell
