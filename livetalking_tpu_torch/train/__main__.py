from livetalking_tpu_torch.train.cli import main

main()
