from repro_torch.service.coordinator import main

if __name__ == "__main__":
    main()
