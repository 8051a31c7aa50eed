"""L0 math substrate: Lie ops, camera models, chi2 tables, image ops."""
