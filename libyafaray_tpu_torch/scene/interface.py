"""The flat scene-building interface (port of
libyafaray_tpu/scene/interface.py, the reference's yafrayInterface_t):
a params accumulator (params_set_* then create_*), geometry streaming and
the render entry, one object over the port's `Scene`.

`XmlExportInterface` is the same call surface writing scene XML instead
of rendering (the reference's xmlinterface.cc): its `render` returns the
XML of everything built so far (scene/xml_writer.py), or writes it to a
file.
"""
from __future__ import annotations

from .params import ParamMap
from .scene import Scene


class Interface:
    """params_set_int / params_set_float / ... + create_* + render."""

    def __init__(self):
        self.scene = Scene()
        self._params = ParamMap()
        self._list: list | None = None
        self._cur_list_item: ParamMap | None = None

    # ---- params accumulator -------------------------------------------
    def params_clear_all(self):
        self._params = ParamMap()
        self._list = None
        self._cur_list_item = None

    def _target(self) -> ParamMap:
        return (self._cur_list_item if self._cur_list_item is not None
                else self._params)

    def params_set_int(self, name, v):
        self._target()[name] = int(v)

    def params_set_float(self, name, v):
        self._target()[name] = float(v)

    def params_set_bool(self, name, v):
        self._target()[name] = bool(v)

    def params_set_string(self, name, v):
        self._target()[name] = str(v)

    def params_set_color(self, name, r, g, b, a=1.0):
        self._target()[name] = (float(r), float(g), float(b), float(a))

    def params_set_point(self, name, x, y, z):
        self._target()[name] = (float(x), float(y), float(z))

    def params_set_matrix(self, name, m16):
        self._target()[name] = tuple(float(x) for x in m16)

    # list params (shader-node lists inside materials)
    def params_start_list(self):
        self._list = []
        self._params["__list__"] = self._list

    def params_push_list(self):
        self._cur_list_item = ParamMap()
        self._list.append(self._cur_list_item)

    def params_end_list(self):
        self._cur_list_item = None

    # ---- geometry streaming --------------------------------------------
    def start_geometry(self):
        return True

    def end_geometry(self):
        return True

    def start_tri_mesh(self, mesh_id=None, nverts=0, ntris=0,
                       has_orco=False, has_uv=False, mesh_type=0,
                       visibility="normal"):
        """Start a mesh (the next free id when mesh_id is None); nverts,
        ntris and mesh_type are the reference API's hints, unused."""
        if mesh_id is None:
            mesh_id = self.scene._next_mesh_id
        return self.scene.start_tri_mesh(int(mesh_id), has_uv=has_uv,
                                         visibility=visibility,
                                         has_orco=has_orco)

    def add_vertex(self, x, y, z):
        return self.scene.add_vertex(x, y, z)

    def add_normal(self, x, y, z):
        self.scene.add_normal(x, y, z)

    def add_uv(self, u, v):
        return self.scene.add_uv(u, v)

    def _mat_id(self, mat) -> int:
        if isinstance(mat, str):
            return self.scene.material_names.get(mat, 0)
        return int(mat)

    def add_triangle(self, a, b, c, mat=0):
        self.scene.add_triangle(a, b, c, self._mat_id(mat))

    def add_triangle_uv(self, a, b, c, ua, ub, uc, mat=0):
        self.scene.add_triangle(a, b, c, self._mat_id(mat), ua, ub, uc)

    def end_tri_mesh(self):
        self.scene.end_tri_mesh()

    def smooth_mesh(self, mesh_id, angle):
        self.scene.smooth_mesh(mesh_id, angle)

    def add_instance(self, base_id, m16):
        self.scene.add_instance(base_id, m16)

    # ---- factories -----------------------------------------------------
    def _create(self, fn, name):
        out = fn(name, self._params)
        self.params_clear_all()
        return out

    def create_texture(self, name):
        return self._create(self.scene.create_texture, name)

    def create_material(self, name):
        return self._create(self.scene.create_material, name)

    def create_light(self, name):
        return self._create(self.scene.create_light, name)

    def create_camera(self, name):
        return self._create(self.scene.create_camera, name)

    def create_background(self, name):
        return self._create(self.scene.create_background, name)

    def create_integrator(self, name):
        self._create(self.scene.create_integrator, name)

    def create_volume_region(self, name):
        return self._create(self.scene.create_volume_region, name)

    # ---- render --------------------------------------------------------
    def render(self, progress_cb=None, film_path=None, device="cuda"):
        """The accumulated params become the render params; renders the
        scene through `render_scene` on `device` (the card by default)."""
        self.scene.set_render_params(self._params)
        self.params_clear_all()
        from .session import render_scene

        return render_scene(self.scene, device=device,
                            progress_cb=progress_cb, film_path=film_path)

    def abort(self):
        self.scene.abort()

    def clear_all(self):
        self.scene = Scene()
        self.params_clear_all()

    @staticmethod
    def get_version() -> str:
        from .. import __version__

        return __version__


class XmlExportInterface(Interface):
    """The same calls, serialised to scene XML instead of rendered."""

    def __init__(self, path: str | None = None):
        super().__init__()
        self.path = path

    def render(self, progress_cb=None, film_path=None, device=None):
        """The XML of the scene built so far (the accumulated params as its
        render block), written to `path` when one was given."""
        from .xml_writer import write_xml

        self.scene.set_render_params(self._params)
        self.params_clear_all()
        xml = write_xml(self.scene)
        if self.path:
            with open(self.path, "w") as f:
                f.write(xml)
        return xml
