"""Protection core: checksums, layout, parity, redo log, the engine."""
