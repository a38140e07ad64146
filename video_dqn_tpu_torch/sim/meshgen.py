"""Procedural scene meshes for the mesh simulator (counterpart of
video_dqn_tpu/sim/meshgen.py, value for value): small generated geometry
in place of licensed Gibson scenes. The maze extrusion shares the fake
env's coordinates; the two-floor ramp house exercises floor inference and
the stair-rejection undo; the furnished house adds rooms, door gaps and
one furniture box per target class on both floors.

All generators return (vertices (N,3) float32, faces (M,3) int32,
colors (N,3) uint8); furnished_house_mesh adds the object map.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class MeshBuilder:
    def __init__(self):
        self.verts: List[Tuple[float, float, float]] = []
        self.faces: List[Tuple[int, int, int]] = []
        self.colors: List[Tuple[int, int, int]] = []

    def quad(self, p0, p1, p2, p3, color):
        """Counter-clockwise quad -> two triangles."""
        base = len(self.verts)
        for p in (p0, p1, p2, p3):
            self.verts.append(tuple(float(x) for x in p))
            self.colors.append(color)
        self.faces.append((base, base + 1, base + 2))
        self.faces.append((base, base + 2, base + 3))

    def box(self, lo, hi, color):
        """Axis-aligned box from corner lo to corner hi (all 6 faces)."""
        x0, y0, z0 = lo
        x1, y1, z1 = hi
        # bottom / top
        self.quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1), color)
        self.quad((x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0), color)
        # sides
        self.quad((x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0), color)
        self.quad((x1, y0, z1), (x1, y1, z1), (x0, y1, z1), (x0, y0, z1), color)
        self.quad((x0, y0, z1), (x0, y1, z1), (x0, y1, z0), (x0, y0, z0), color)
        self.quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1), color)

    def build(self):
        return (
            np.asarray(self.verts, np.float32),
            np.asarray(self.faces, np.int32),
            np.asarray(self.colors, np.uint8),
        )


def _cell_color(zi: int, xi: int) -> Tuple[int, int, int]:
    h = (zi * 2654435761 + xi * 40503) & 0xFFFFFFFF
    return (60 + (h & 127), 60 + ((h >> 7) & 127), 60 + ((h >> 14) & 127))


def maze_mesh(maze: Sequence[str], cell: float = 0.5,
              wall_height: float = 2.5, floor_y: float = 0.0):
    """Extrude an occupancy-grid maze ('#' = wall) into a 3-D scene: one
    floor slab + a box per wall cell, with deterministic per-cell colors so
    rendered views are position-dependent (mirroring the grid renderer's
    hashed RGB). Geometry aligns with FakeNavEnv's coordinates: cell (zi,
    xi) spans x in [xi*cell, (xi+1)*cell), z likewise."""
    b = MeshBuilder()
    gh, gw = len(maze), len(maze[0])
    b.quad(
        (0, floor_y, 0), (0, floor_y, gh * cell),
        (gw * cell, floor_y, gh * cell), (gw * cell, floor_y, 0),
        (110, 110, 105),
    )
    for zi, row in enumerate(maze):
        for xi, ch in enumerate(row):
            if ch == "#":
                b.box(
                    (xi * cell, floor_y, zi * cell),
                    ((xi + 1) * cell, floor_y + wall_height, (zi + 1) * cell),
                    _cell_color(zi, xi),
                )
    return b.build()


def ramp_house_mesh(cell: float = 0.5, wall_height: float = 2.7,
                    floor_gap: float = 3.0, size: int = 12):
    """Two-floor house connected by a straight ramp ("stairs"): ground
    floor at y=0, upper floor at y=floor_gap, ramp along +z on the east
    side. Walking onto the ramp raises the floor height under the agent by
    more than 0.2 m within a step or two, which triggers the env's
    stair-climb undo."""
    b = MeshBuilder()
    w = size * cell  # house is w x w meters per floor
    # ground floor slab
    b.quad((0, 0, 0), (0, 0, w), (w, 0, w), (w, 0, 0), (110, 110, 105))
    # upper floor slab with a stairwell opening on the east edge
    # (x in [w - 1.5*cell, w]) so the ramp connects through it
    open_x = w - 3 * cell
    b.quad((0, floor_gap, 0), (0, floor_gap, w), (open_x, floor_gap, w),
           (open_x, floor_gap, 0), (120, 105, 100))
    # perimeter walls spanning both floors
    top = floor_gap + wall_height
    t = 0.1  # wall thickness
    b.box((0, 0, 0), (w, top, t), (90, 100, 120))
    b.box((0, 0, w - t), (w, top, w), (90, 100, 120))
    b.box((0, 0, 0), (t, top, w), (100, 90, 120))
    b.box((w - t, 0, 0), (w, top, w), (100, 90, 120))
    # the ramp: from (open_x, 0) at z=t rising to floor_gap at z=w-t
    n_seg = 16
    z0, z1 = 2 * t, w - 2 * t
    for i in range(n_seg):
        za = z0 + (z1 - z0) * i / n_seg
        zb = z0 + (z1 - z0) * (i + 1) / n_seg
        ya = floor_gap * i / n_seg
        yb = floor_gap * (i + 1) / n_seg
        b.quad((open_x, ya, za), (open_x, yb, zb), (w - t, yb, zb),
               (w - t, ya, za), (160, 120, 80))
    return b.build()


def wall_scene(distance: float = 2.0, half_width: float = 5.0,
               height: float = 4.0):
    """A single flat wall facing the origin at z = -distance (the agent
    looks along -z at yaw 0) plus a floor — the analytic render oracle."""
    b = MeshBuilder()
    b.quad(
        (-half_width, -1.0, -distance), (-half_width, height, -distance),
        (half_width, height, -distance), (half_width, -1.0, -distance),
        (200, 50, 50),
    )
    b.quad((-half_width, -1.25, -half_width), (-half_width, -1.25, half_width),
           (half_width, -1.25, half_width), (half_width, -1.25, -half_width),
           (80, 80, 80))
    return b.build()


# Furniture footprints (w, h, d in meters) per target class
_FURNITURE = {
    "bed": (1.9, 0.55, 1.5, (200, 200, 230)),
    "chair": (0.5, 0.9, 0.5, (150, 100, 60)),
    "couch": (1.8, 0.8, 0.85, (90, 140, 90)),
    "dining table": (1.4, 0.75, 0.9, (160, 120, 70)),
    "toilet": (0.45, 0.75, 0.45, (230, 230, 230)),
}


def furnished_house_mesh(cell: float = 0.5, wall_height: float = 2.7,
                         floor_gap: float = 3.0, size: int = 16):
    """Two-floor house with interior room walls (door gaps), a connecting
    ramp, and one furniture box per target class placed across both
    floors. Returns (vertices, faces, colors, objects) where objects maps
    class -> list of (x, y, z) object centers, as a 3DSceneGraph's object
    locations."""
    b = MeshBuilder()
    w = size * cell
    t = 0.1
    # floors: ground slab + upper slab with stairwell opening on the east
    b.quad((0, 0, 0), (0, 0, w), (w, 0, w), (w, 0, 0), (110, 110, 105))
    open_x = w - 3 * cell
    b.quad((0, floor_gap, 0), (0, floor_gap, w), (open_x, floor_gap, w),
           (open_x, floor_gap, 0), (120, 105, 100))
    # perimeter walls spanning both floors
    top = floor_gap + wall_height
    b.box((0, 0, 0), (w, top, t), (90, 100, 120))
    b.box((0, 0, w - t), (w, top, w), (90, 100, 120))
    b.box((0, 0, 0), (t, top, w), (100, 90, 120))
    b.box((w - t, 0, 0), (w, top, w), (100, 90, 120))
    # ground-floor interior wall with a door gap (rooms along z)
    zmid = w / 2
    door_w = 1.2
    b.box((t, 0, zmid - t), (w / 2 - door_w, wall_height, zmid + t),
          (130, 130, 140))
    b.box((w / 2 + door_w, 0, zmid - t), (open_x - cell, wall_height, zmid + t),
          (130, 130, 140))
    # upper-floor interior wall with a door gap (rooms along x)
    xmid = open_x / 2
    b.box((xmid - t, floor_gap, t), (xmid + t, floor_gap + wall_height,
                                     w / 2 - door_w), (140, 130, 130))
    b.box((xmid - t, floor_gap, w / 2 + door_w),
          (xmid + t, floor_gap + wall_height, w - t), (140, 130, 130))
    # the ramp
    n_seg = 16
    z0, z1 = 2 * t, w - 2 * t
    for i in range(n_seg):
        za = z0 + (z1 - z0) * i / n_seg
        zb = z0 + (z1 - z0) * (i + 1) / n_seg
        ya = floor_gap * i / n_seg
        yb = floor_gap * (i + 1) / n_seg
        b.quad((open_x, ya, za), (open_x, yb, zb), (w - t, yb, zb),
               (w - t, ya, za), (160, 120, 80))

    # furniture: alternate floors, corners of rooms
    placements = {
        "bed": (1.6, 0.0, 1.6),
        "couch": (1.6, 0.0, w - 2.0),
        "toilet": (w / 2 + 1.0, 0.0, 1.2),
        "dining table": (1.6, floor_gap, 1.6),
        "chair": (open_x - 1.6, floor_gap, w - 2.0),
    }
    objects = {}
    for cls, (cx, cy, cz) in placements.items():
        fw, fh, fd, color = _FURNITURE[cls]
        b.box((cx - fw / 2, cy, cz - fd / 2),
              (cx + fw / 2, cy + fh, cz + fd / 2), color)
        objects[cls] = [np.array([cx, cy, cz])]
    verts, faces, colors = b.build()
    return verts, faces, colors, objects
