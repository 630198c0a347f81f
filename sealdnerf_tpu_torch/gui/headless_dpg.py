"""Headless implementation of the dearpygui API subset the viewers use
(port of sealdnerf_tpu/gui/headless_dpg.py; plain Python).

The reference stack is built on dearpygui (nerf/gui.py, SealNeRF/gui.py,
SealDNeRF/gui.py). This module implements the same module-level API
(widget registry with tags/labels/values, callbacks, container context
managers, mouse handler registry, a frame loop) without a display, so
the *actual view-layer code* in nerf_gui.py / seal_gui.py / seald_gui.py
runs where dearpygui or a display is missing: CI, remote GPU hosts,
scripted editing sessions.

Beyond API fidelity it adds a small driver surface for scripting and
tests (underscore-free names that real dearpygui does not define, so a
viewer written against real dpg never collides):

    configure(max_frames=N)   stop the frame loop after N frames
    set_mouse_pos(x, y)       position returned by get_mouse_pos()
    emit_drag(button, dx, dy) fire mouse-drag handlers (app_data =
                              [button, dx, dy], like real dpg)
    emit_wheel(delta)         fire mouse-wheel handlers
    emit_click(button)        fire mouse-click handlers
    click_item(tag_or_label)  invoke a button callback
    set_widget(tag, value)    set a widget value AND fire its callback
                              (what a user interaction does)

Callbacks are invoked arity-adaptively with (sender, app_data,
user_data) truncated to the callable's signature, matching dearpygui's
dispatch behavior.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# ---------------------------------------------------------------- constants
mvFormat_Float_rgb = "float_rgb"
mvFormat_Float_rgba = "float_rgba"
mvMouseButton_Left = 0
mvMouseButton_Right = 1
mvMouseButton_Middle = 2


@dataclass
class _Item:
    kind: str
    tag: str
    label: Optional[str] = None
    value: Any = None
    callback: Optional[Callable] = None
    user_data: Any = None
    config: Dict[str, Any] = field(default_factory=dict)
    children: List[str] = field(default_factory=list)


class _State:
    def __init__(self):
        self.items: Dict[str, _Item] = {}
        self.handlers: List[_Item] = []
        self.running = False
        self.frame_count = 0
        self.max_frames: Optional[int] = None
        self.mouse_pos = (0.0, 0.0)
        self.primary_window: Optional[str] = None
        self.viewport: Dict[str, Any] = {}
        self._auto_tag = 0
        self._container_stack: List[_Item] = []

    def new_tag(self) -> str:
        self._auto_tag += 1
        return f"__item_{self._auto_tag}"


_S: Optional[_State] = None


def _state() -> _State:
    if _S is None:
        raise RuntimeError("no context: call create_context() first")
    return _S


def _call(cb: Optional[Callable], sender=None, app_data=None,
          user_data=None):
    """Arity-adaptive callback dispatch (dearpygui passes up to three
    positional args but truncates to the callable's signature)."""
    if cb is None:
        return
    try:
        sig = inspect.signature(cb)
        n = len([p for p in sig.parameters.values()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
        if any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()):
            n = 3
    except (TypeError, ValueError):
        n = 3
    args = (sender, app_data, user_data)[:min(n, 3)]
    return cb(*args)


def _add(kind: str, *, tag: Optional[str] = None, label=None, value=None,
         callback=None, user_data=None, **config) -> str:
    s = _state()
    tag = tag or s.new_tag()
    item = _Item(kind=kind, tag=tag, label=label, value=value,
                 callback=callback, user_data=user_data, config=config)
    s.items[tag] = item
    if s._container_stack:
        s._container_stack[-1].children.append(tag)
    return tag


# ------------------------------------------------------------ context mgmt
def create_context():
    global _S
    _S = _State()


def destroy_context():
    global _S
    _S = None


def create_viewport(title="", width=1280, height=800, resizable=True,
                    **kw):
    _state().viewport = dict(title=title, width=width, height=height,
                             resizable=resizable, **kw)


def setup_dearpygui():
    pass


def show_viewport():
    _state().running = True


def set_primary_window(tag, value=True):
    _state().primary_window = tag if value else None


def is_dearpygui_running() -> bool:
    s = _state()
    if s.max_frames is not None and s.frame_count >= s.max_frames:
        return False
    return s.running


def render_dearpygui_frame():
    _state().frame_count += 1


def stop_dearpygui():
    _state().running = False


# --------------------------------------------------------------- containers
@contextlib.contextmanager
def _container(kind, **kw):
    s = _state()
    tag = _add(kind, **kw)
    s._container_stack.append(s.items[tag])
    try:
        yield tag
    finally:
        s._container_stack.pop()


def window(tag=None, label=None, width=0, height=0, **kw):
    return _container("window", tag=tag, label=label, width=width,
                      height=height, **kw)


def group(horizontal=False, tag=None, **kw):
    return _container("group", tag=tag, horizontal=horizontal, **kw)


def texture_registry(show=False, tag=None, **kw):
    return _container("texture_registry", tag=tag, show=show, **kw)


def handler_registry(tag=None, **kw):
    return _container("handler_registry", tag=tag, **kw)


# ------------------------------------------------------------------ widgets
def add_raw_texture(width, height, default_value, format=None, tag=None,
                    **kw):
    return _add("raw_texture", tag=tag, value=default_value, width=width,
                height=height, format=format, **kw)


def add_image(texture_tag, tag=None, **kw):
    return _add("image", tag=tag, texture=texture_tag, **kw)


def add_text(default_value="", tag=None, **kw):
    return _add("text", tag=tag, value=default_value, **kw)


def add_button(label=None, tag=None, callback=None, user_data=None, **kw):
    return _add("button", tag=tag, label=label, callback=callback,
                user_data=user_data, **kw)


def add_slider_float(label=None, tag=None, default_value=0.0,
                     min_value=0.0, max_value=1.0, callback=None, **kw):
    return _add("slider_float", tag=tag, label=label, value=default_value,
                callback=callback, min_value=min_value,
                max_value=max_value, **kw)


def add_slider_int(label=None, tag=None, default_value=0, min_value=0,
                   max_value=100, callback=None, **kw):
    return _add("slider_int", tag=tag, label=label, value=default_value,
                callback=callback, min_value=min_value,
                max_value=max_value, **kw)


def add_checkbox(label=None, tag=None, default_value=False, callback=None,
                 **kw):
    return _add("checkbox", tag=tag, label=label, value=default_value,
                callback=callback, **kw)


def add_input_text(label=None, tag=None, default_value="", callback=None,
                   **kw):
    return _add("input_text", tag=tag, label=label, value=default_value,
                callback=callback, **kw)


def add_color_edit(label=None, tag=None, default_value=(255, 255, 255),
                   callback=None, **kw):
    return _add("color_edit", tag=tag, label=label,
                value=tuple(default_value), callback=callback, **kw)


def add_combo(items=(), label=None, tag=None, default_value="",
              callback=None, **kw):
    return _add("combo", tag=tag, label=label, value=default_value,
                callback=callback, items=list(items), **kw)


# ------------------------------------------------------------ mouse handlers
def add_mouse_drag_handler(button=-1, callback=None, tag=None, **kw):
    tag = _add("mouse_drag_handler", tag=tag, callback=callback,
               button=button, **kw)
    _state().handlers.append(_state().items[tag])
    return tag


def add_mouse_wheel_handler(callback=None, tag=None, **kw):
    tag = _add("mouse_wheel_handler", tag=tag, callback=callback, **kw)
    _state().handlers.append(_state().items[tag])
    return tag


def add_mouse_click_handler(button=-1, callback=None, tag=None, **kw):
    tag = _add("mouse_click_handler", tag=tag, callback=callback,
               button=button, **kw)
    _state().handlers.append(_state().items[tag])
    return tag


# ------------------------------------------------------------- value access
def set_value(tag, value):
    s = _state()
    if tag in s.items:
        s.items[tag].value = value


def get_value(tag):
    s = _state()
    return s.items[tag].value if tag in s.items else None


def set_item_label(tag, label):
    s = _state()
    if tag in s.items:
        s.items[tag].label = label


def get_item_label(tag):
    s = _state()
    return s.items[tag].label if tag in s.items else None


def get_mouse_pos(local=True):
    return _state().mouse_pos


def does_item_exist(tag) -> bool:
    return tag in _state().items


# ============================================================ driver surface
def configure(max_frames: Optional[int] = None):
    """Bound the frame loop (is_dearpygui_running goes False after
    max_frames render_dearpygui_frame calls)."""
    _state().max_frames = max_frames


def set_mouse_pos(x: float, y: float):
    _state().mouse_pos = (float(x), float(y))


def _find(tag_or_label: str) -> _Item:
    s = _state()
    if tag_or_label in s.items:
        return s.items[tag_or_label]
    matches = [it for it in s.items.values() if it.label == tag_or_label]
    if not matches:
        raise KeyError(f"no item with tag or label {tag_or_label!r}")
    return matches[0]


def click_item(tag_or_label: str):
    """Invoke a button's callback, as a user click would."""
    it = _find(tag_or_label)
    _call(it.callback, sender=it.tag, app_data=None,
          user_data=it.user_data)


def set_widget(tag_or_label: str, value):
    """Set a widget's value and fire its callback with that value (what
    interacting with a slider/checkbox/input does)."""
    it = _find(tag_or_label)
    it.value = value
    _call(it.callback, sender=it.tag, app_data=value,
          user_data=it.user_data)


def emit_drag(button: int, dx: float, dy: float):
    """Fire mouse-drag handlers for `button`; app_data = [button, dx, dy]
    (real dearpygui's drag payload)."""
    for h in list(_state().handlers):
        if h.kind == "mouse_drag_handler" and \
                h.config.get("button") in (button, -1):
            _call(h.callback, sender=h.tag, app_data=[button, dx, dy],
                  user_data=h.user_data)


def emit_wheel(delta: float):
    for h in list(_state().handlers):
        if h.kind == "mouse_wheel_handler":
            _call(h.callback, sender=h.tag, app_data=delta,
                  user_data=h.user_data)


def emit_click(button: int):
    for h in list(_state().handlers):
        if h.kind == "mouse_click_handler" and \
                h.config.get("button") in (button, -1):
            _call(h.callback, sender=h.tag, app_data=button,
                  user_data=h.user_data)
