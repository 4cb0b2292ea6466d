"""renderer_idle_ms: device idle ms a frame inside the device-side spans of
the program's `frame` range (a renderer's render_device) and outside its
`trace_wave` spans: the renderer's own gaps between waves. The window's
other idle time lies between frames."""

from .tracer_idle_ms import idle_ms_a_frame


def read(run):
    return None if run.trace is None else \
        idle_ms_a_frame(run.trace, ["frame"], ["trace_wave"])
