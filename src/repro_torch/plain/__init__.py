"""Plain references of models the port serves, each written apart from the port (nothing here imports ``repro_torch`` or ``repro``): ``zamba2``, published Zamba2."""
