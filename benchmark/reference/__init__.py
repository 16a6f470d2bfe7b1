"""Plain float32 references of the configurations the benchmark runs. A
configuration file names its reference by the module's name here."""
