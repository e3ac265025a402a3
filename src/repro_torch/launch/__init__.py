"""Training launch (port of ``repro.launch``): the one-card trainer
(``train``) and its mesh description (``mesh``).  The production meshes,
parameter sharding, the dry run and the HLO analysis wait for item 20's
``launch/`` part (ROADMAP Queue 1)."""
