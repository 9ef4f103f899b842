"""The closed-loop drivers of the mixes, one module per ``entry`` that a
mix file names: ``fit_lanes`` (the PheWAS fit over a resident GRM) and
``scan_models`` (the multi-model scan of a GDS file)."""
