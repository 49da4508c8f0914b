from .data_format import DataFormat, SH, RGBA
from .tree import N3Tree, load_npz_host, tree_from_numpy
from .synthetic import sphere_tree, shell_tree, build_host_tree, \
    field_tree_arrays, random_tree

__all__ = [
    "DataFormat", "SH", "RGBA",
    "N3Tree", "load_npz_host",
    "sphere_tree", "random_tree", "shell_tree", "build_host_tree",
    "field_tree_arrays",
]
