"""The GUI on a data mesh: rank 0's window drives every rank's controller.

On a mesh of N ranks (parallel/mesh.py) rank 0 alone opens the view. Its
view changes its controller only through the controller's methods and
attribute sets (train_frame, render_frame, set_time, the camera moves,
start_edit_training, override_teacher, the tools' settings, ...), and
`Leader` broadcasts each of them, as the method's name and its arguments
or the attribute's name and value, before it runs on rank 0. The other
ranks run `follow`: they make the same call on their own controller, so
that every collective inside it (a sharded training step, a row-band
frame, the edit's proxy) is met on every rank, and the controllers' pacing
reads rank 0's clock (controller.GUIController._rank0). Closing the window
ends the view's loop on rank 0, which then tells the others to return.
"""

import inspect

from ..parallel.mesh import broadcast_object

CLOSE = "close"
# methods of the controller that only read it (the view's overlay)
LOCAL = frozenset({"display_frame"})


class Leader:
    """Rank 0's controller as its view sees it: every public method call
    and every attribute set is broadcast to the other ranks, then made
    here; attribute reads are the controller's."""

    def __init__(self, ctl, mesh):
        object.__setattr__(self, "_ctl", ctl)
        object.__setattr__(self, "_mesh", mesh)

    def __getattr__(self, name):
        value = getattr(self._ctl, name)
        if name.startswith("_") or name in LOCAL or \
                not inspect.ismethod(value):
            return value

        def call(*args, **kw):
            broadcast_object(self._mesh, ("call", name, args, kw))
            return value(*args, **kw)
        return call

    def __setattr__(self, name, value):
        broadcast_object(self._mesh, ("set", name, value))
        setattr(self._ctl, name, value)

    def close(self):
        """Tell the other ranks that the window closed."""
        broadcast_object(self._mesh, (CLOSE,))


def follow(ctl, mesh):
    """A rank above 0: make each call and attribute set that rank 0's
    Leader broadcasts on `ctl`, until it closes."""
    while True:
        msg = broadcast_object(mesh, None)
        if msg[0] == CLOSE:
            return
        kind, name, *rest = msg
        if kind == "set":
            setattr(ctl, name, rest[0])
        else:
            getattr(ctl, name)(*rest[0], **rest[1])


def run_view(make_view, ctl, drive=None):
    """Open make_view(controller) on `ctl` and run its frame loop
    (drive(view); default view.render()) -> the view on rank 0 of ctl's
    trainer's mesh, None on the other ranks, which follow rank 0 until its
    window closes. On one rank the view takes ctl itself."""
    drive = drive or (lambda view: view.render())
    mesh = ctl.trainer.mesh
    if mesh.size == 1:
        view = make_view(ctl)
        drive(view)
        return view
    if mesh.rank != 0:
        follow(ctl, mesh)
        return None
    lead = Leader(ctl, mesh)
    try:
        view = make_view(lead)
        drive(view)
    finally:
        lead.close()
    return view
