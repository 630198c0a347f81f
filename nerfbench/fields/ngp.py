"""The Instant-NGP field family (configurations with "model": "ngp"): the
program's FastTrainer on the static hash-grid field without its background
sphere, built by the CLI's route for `--backbone ngp`, and the plain
reference's side of its checks.

It gives the loops what fields/cp.py gives them. The reference's steps,
grid and frames are fields/cp.py's functions, run on private copies of
reference/render.py, grid.py and train.py and of fields/cp.py itself whose
field is reference/ngp_field.py (`_bound_copy`): the march, compositing,
bucketed frames, grid refresh and Adam of the two families are the same
equations, and only the field differs. The copies leave the files as they
are.
"""

import importlib.util
import os

from nerfbench.reference import ngp_field as nf
from nerfbench.work_hash import tower_dims

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bound_copy(kind: str, name: str, **names):
    """A private copy of the module `<kind>/<name>.py` of the benchmark, in
    the package `nerfbench.<kind>` (its relative imports resolve there), with
    the module-level `names` rebound after it loads."""
    spec = importlib.util.spec_from_file_location(
        f"nerfbench.{kind}._ngp_{name}", os.path.join(BENCH, kind,
                                                       name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = f"nerfbench.{kind}"
    spec.loader.exec_module(mod)
    mod.__dict__.update(names)
    return mod


rr = _bound_copy("reference", "render", rf=nf)
rg = _bound_copy("reference", "grid", rf=nf)
rt = _bound_copy("reference", "train", rf=nf, rr=rr)
_cp = _bound_copy("fields", "cp", rf=nf, rr=rr, rg=rg, rt=rt)

# the reference's side, as fields/cp.py computes it for a static field
reference_steps = _cp.reference_steps
reference_grid = _cp.reference_grid
grid_occupancy = _cp.grid_occupancy
reference_frame = _cp.reference_frame
reference_frames = _cp.reference_frames
frame_inputs = _cp.frame_inputs
train_settings = _cp.train_settings
time_bin = _cp.time_bin
training_data = _cp.training_data


def param_shapes(cfg: dict):
    """The field's parameter tree as shapes: [(path, shape)] in the
    program's names and layouts (the table [rows, level_dim], the towers'
    matrices [in, out])."""
    sigma, color = tower_dims(cfg)
    out = [(("grid",), (nf.table_rows(cfg), cfg["level_dim"]))]
    for name, d in (("sigma_mlp", sigma), ("color_mlp", color)):
        out += [((name, "w", i), (d[i], d[i + 1]))
                for i in range(len(d) - 1)]
    return out


# ------------------------------------------------------------ the program
def build_trainer(cell, seed: int, device: str, workspace: str,
                  extra_args=()):
    """The program's trainer, built by cli.build_trainer from main_nerf's
    parser on the configuration's flags (`--backbone ngp` at bg_radius <= 0:
    FastTrainer on the Instant-NGP field, seeded from --seed by the CLI),
    with the training options the configuration sets -> (trainer, a copy of
    its seeded params, its TrainOptions). The trainer's field must be the
    configuration file's."""
    from nerfbench.capture import clone_tree
    from sealdnerf_tpu_torch import cli
    from sealdnerf_tpu_torch.models.params import param_leaves
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    argv = list(cell.config["cli"]) + [
        "--seed", str(seed), "--workspace", workspace, "--ckpt", "scratch",
        "--device", device] + list(extra_args)
    opt = cli.postprocess(cli.base_parser().parse_args(argv))
    trainer, field = cli.build_trainer(opt, name="ngp",
                                       **cell.config.get("options", {}))
    if type(trainer) is not FastTrainer:
        raise RuntimeError(f"{cell.name}: the CLI built {type(trainer)}, "
                           "not FastTrainer")
    shapes = [tuple(s) for _, s in param_shapes(cell.field)]
    got = sorted(tuple(t.shape) for t in param_leaves(trainer.params))
    if got != sorted(shapes) or field.cfg.bound != cell.field["bound"]:
        raise RuntimeError(f"{cell.name}: the CLI's field {got} is not the "
                           f"configuration's {sorted(shapes)}")
    return trainer, clone_tree(trainer.params), trainer.opt
