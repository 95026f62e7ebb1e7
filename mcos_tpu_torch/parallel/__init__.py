"""Path-sharded Monte Carlo over a mesh of torch devices
(counterpart of `mcos_tpu/parallel/`): `mesh` holds the mesh, the one
pooling function and the drivers with the reference's own shapes,
`families` the moment-pooled driver of every model family."""
