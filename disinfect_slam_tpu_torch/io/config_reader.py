"""Camera YAML parsing without PyYAML (counterpart of
disinfect_slam_tpu/io/config_reader.py; reference config_reader.hpp:13-30).

The camera files (configs/*.yaml, datasets/*/cam.yaml) are flat
`key: value` maps, with at most a flow-style list of numbers
(`Extrinsics: [...]`, possibly over several lines).  That subset is what
this reader accepts; anything else raises ValueError.
"""

from __future__ import annotations

import numpy as np


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if ch in "\"'":
            quote = None if quote == ch else (quote or ch)
        elif ch == "#" and quote is None:
            return line[:i]
    return line


def load_yaml(path: str) -> dict:
    """Parse a flat camera YAML into a dict."""
    out: dict = {}
    pending_key, pending = None, ""
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = _strip_comment(raw).strip()
            if pending_key is not None:
                pending += " " + line
                if "]" in line:
                    out[pending_key] = _list(pending, path, lineno)
                    pending_key = None
                continue
            if not line or line.startswith("%") or line == "---":
                continue
            key, sep, value = line.partition(":")
            if not sep or raw[:1].isspace():
                raise ValueError(f"{path}:{lineno}: not a flat 'key: value' line")
            key, value = key.strip(), value.strip()
            if value.startswith("["):
                if "]" in value:
                    out[key] = _list(value, path, lineno)
                else:
                    pending_key, pending = key, value
            elif value:
                out[key] = _scalar(value)
            else:
                raise ValueError(f"{path}:{lineno}: nested maps are not supported")
    if pending_key is not None:
        raise ValueError(f"{path}: unterminated list for {pending_key!r}")
    return out


def _list(text: str, path: str, lineno: int) -> list:
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise ValueError(f"{path}:{lineno}: malformed list")
    return [_scalar(v) for v in body[1:-1].split(",") if v.strip()]


def get_intrinsics(config: dict) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) from Camera.* keys (config_reader.hpp:13-17)."""
    return tuple(float(config[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy"))


def get_depth_factor(config: dict) -> float:
    """depthmap_factor (config_reader.hpp:19-22)."""
    return float(config["depthmap_factor"])


def get_extrinsics(config: dict) -> np.ndarray:
    """4x4 cam_T_posecam from the row-major 'Extrinsics' list
    (config_reader.hpp:24-30); identity when absent (offline.cc:40-43)."""
    ext = config.get("Extrinsics")
    if ext is None:
        return np.eye(4, dtype=np.float32)
    return np.asarray(ext, np.float32).reshape(4, 4)


def get_image_size(config: dict) -> tuple[int, int]:
    """(height, width) from Camera.rows / Camera.cols."""
    return int(config["Camera.rows"]), int(config["Camera.cols"])
