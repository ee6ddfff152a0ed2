"""Structure primitives: box, dimension, topology, shapes."""
