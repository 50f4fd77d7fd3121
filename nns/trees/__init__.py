from nns.trees.kdtree import KDTree, nns_kdtree_host  # noqa: F401
from nns.trees.kdtree_device import nns_kdtree_device  # noqa: F401
from nns.trees.octree import Octree, nns_octree_host  # noqa: F401
from nns.trees.octree_device import nns_octree_device  # noqa: F401
