from repro_torch.utils.tree import tree_bytes, tree_map_with_path, tree_size

__all__ = ["tree_bytes", "tree_map_with_path", "tree_size"]
