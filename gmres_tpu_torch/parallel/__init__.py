"""Distribution over ranks: the 1-D device mesh, row-sharded grid vectors
(DTensor), and the explicit halo-exchange stencil path."""
