"""Domain decomposition of the lattice over shards (parallel/mesh.py)."""
