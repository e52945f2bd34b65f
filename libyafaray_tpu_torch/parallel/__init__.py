"""Multi-device rendering over torch.distributed (port of
libyafaray_tpu/parallel): one process a device, the film's pixel rows
split into one band a rank, photon lanes split the same way.

  distributed.py  the process group (explicit arguments or torchrun's
                  environment), the backend rule, the collectives, local
                  ranks started with the spawn method, render_sharded_global
  mesh.py         FilmMesh (rank, world size, device, row band), the plane
                  table film_shardings_for, the summed film, render_sharded
"""
