"""Entry points of the port: the trainer (``launch.train``) and the
serving replica (``launch.serve``), the twins of the examples
(``launch.train_100m``, ``launch.quickstart``), the SpGEMM demo, the stream
service's load generator (``launch.stream_serve``), the process worlds
they run in (``launch.world``), and the tools: the production meshes
(``launch.mesh``), each rank's state bytes (``launch.shard_memory``), the
dry-run (``launch.dryrun``) and its cost analysis
(``launch.hlo_analysis``)."""
