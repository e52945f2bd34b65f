"""`python -m libyafaray_tpu_torch`: the port's yafaray-xml command line
(cli/yafaray_xml.py), as `python -m libyafaray_tpu` is the reference's."""
from libyafaray_tpu_torch.cli.yafaray_xml import main

if __name__ == "__main__":
    raise SystemExit(main())
