"""Ray generation, the procedural scene and the transforms.json loader."""
