"""Model plane: parameter definitions, the dense decoder and its decode path."""
