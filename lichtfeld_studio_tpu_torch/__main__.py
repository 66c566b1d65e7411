from lichtfeld_studio_tpu_torch.cli import main

raise SystemExit(main())
