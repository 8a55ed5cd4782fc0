"""Case providers, the cached dataset and host batch loaders (numpy)."""
